"""Stage 1 (per-modality pretraining) in the port against the JAX package.

  * The decoder's `triples_indexed` (unchunked, and chunked by 3 with its
    recomputed chunks, forward and table gradient) and `pairs_all_labels`
    within 1e-6 relative.
  * `remove_edges_attached_to_drugs` on tests/test_hgt.py's case, and the
    link split's queries, labels and message edges, exactly.
  * 3 steps of each trainer from the JAX trainer's initial weights,
    carried across with `interop/from_flax`: GIN property prediction (with
    its BatchNorm statistics), HGT link prediction (source-sorted layout,
    so the backward is K2's plain version, and scored in chunks of 64
    queries on both sides), the tabular autoencoder with dropout 0, and
    chemCPA adaptation over 4 iterations with and without the adversaries
    (each step kind twice) with `use_drugs` and frozen drug embeddings.
    Losses within 1e-5 relative; every parameter and statistic within
    1e-5, with Adam's allowance on entries whose step-1 gradient is
    rounding noise (a bias ahead of a BatchNorm, an attention key bias):
    Adam's 1/sqrt(v) turns that noise into an update of up to lr either
    way, so those, and the running means that follow such a bias, are held
    to twice the summed rate more. Most tensors move by more than twice
    the tolerance.
  * chemCPA's `reconstruct` (eval and train mode, statistics included)
    and `gaussian_nll_loss`; the encoder that stages 2 and 3 build has no
    decoder and no adversaries.
  * The four evaluations on the same trained weights within 1e-5
    (`evaluate_disentanglement`: its `_optimal` entries exactly, its
    accuracies by invariants, since the probes' inits differ).
  * `overlay_stage1_checkpoint` and `encoder_params_from_stage1` against
    the JAX functions on the same trees, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from madrigal_tpu import config as j_config
from madrigal_tpu.data import kg as j_kg
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.data.molgraph import pack_molecules as j_pack
from madrigal_tpu.models import chemcpa as j_chemcpa
from madrigal_tpu.models.decoder import BilinearDDIScorer as JBilinear
from madrigal_tpu.train import modality_pretrain as j_mp
from madrigal_tpu.train import transfer as j_transfer
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.data import kg as t_kg
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.molgraph import pack_molecules as t_pack
from madrigal_tpu_torch.interop import from_flax
from madrigal_tpu_torch.models import chemcpa as t_chemcpa
from madrigal_tpu_torch.models.decoder import BilinearDDIScorer
from madrigal_tpu_torch.models.encoder import MadrigalEncoder, init_weights
from madrigal_tpu_torch.models.norm import MaskedBatchNorm
from madrigal_tpu_torch.train import modality_pretrain as t_mp
from madrigal_tpu_torch.train import transfer as t_transfer
from madrigal_tpu_torch.train.checkpoint import load_checkpoint
from test_hgt import small_kg

DATA = dict(num_drugs=14, num_labels=4, num_edges=20, seed=3)
FEAT, LR, STEPS = 16, 1e-3, 3


def configs(c):
    """The stage-1 trainers' configs; the stage-2 encoder of `encoder_cfg`
    takes each of their encoders."""
    return dict(
        gin=c.GINConfig(hidden_dims=(16, 16), num_mlp_layer=2),
        hgt=c.HGTConfig(hidden_dim=8, num_layers=2, att_heads=2),
        chemcpa=lambda disable_adv: c.ChemCPAConfig(
            num_genes=30, dim=FEAT, autoencoder_width=32,
            autoencoder_depth=1, num_covariates=4, use_drugs=True,
            num_drugs=6, drug_embedding_dim=9, embedding_encoder_width=8,
            embedding_encoder_depth=1, dosers_width=4, dosers_depth=1,
            adversary_width=16, adversary_depth=1,
            disable_adv=disable_adv))


def np_vars(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def state_dict_of(variables):
    return from_flax.flax_to_state_dict(np_vars(variables))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models are tiny: torch's intra-op threads would only contend
    with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return j_syn.make_dataset(**DATA), t_syn.make_dataset(**DATA)


def run_steps(jt, tt, step_j, step_t, steps=STEPS):
    """`steps` steps of both trainers; (JAX losses, port losses, each
    port parameter's gradient at the first step that updates it, the
    port's weights before)."""
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    lj, lt, grads = [], [], {}
    for _ in range(steps):
        lj.append(step_j())
        lt.append(step_t())
        for k, p in tt.model.named_parameters():
            if p.grad is not None and k not in grads:
                grads[k] = p.grad.clone()
    return lj, lt, grads, before


def loss_values(losses):
    return [v for x in losses for v in (x.values() if isinstance(x, dict)
                                        else [x])]


def assert_steps_match(jt_vars, tt, run, steps=STEPS):
    """Losses within 1e-5 relative; weights and statistics within 1e-5,
    with Adam's allowance on rounding-noise entries (module docstring)."""
    lj, lt, grads, before = run
    np.testing.assert_allclose(loss_values(lt), loss_values(lj), rtol=1e-5)
    want = state_dict_of(jt_vars)
    got = tt.model.state_dict()
    assert want.keys() == got.keys()
    top = max(float(g.abs().max()) for g in grads.values())
    allowance = 2 * LR * steps
    big = 0
    for k, ref in want.items():
        atol = np.full(ref.shape, 1e-5)
        if k in grads:
            atol[(grads[k].abs() <= 1e-6 * top).numpy()] += allowance
        elif k.endswith("running_mean"):
            atol += allowance
        err = np.abs(got[k].numpy() - ref.numpy())
        assert (err <= atol).all(), (k, float(err.max()))
        big += float((ref - before[k]).abs().max()) > 2e-5
    assert big > len(want) // 2, (big, len(want))


# ------------------------------------------------------------- decoder
def assert_close_to_largest(got, want, rel=1e-6):
    """Within `rel` of want's largest entry (sums of products, added in
    another order, cancel on the small entries)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("labels", [1, 3])
@pytest.mark.parametrize("chunk", [0, 3])
def test_triples_indexed_and_pairs_all_labels_match_jax(labels, chunk):
    rng = np.random.RandomState(labels + chunk)
    z = rng.randn(9, 8).astype(np.float32)
    w = rng.randn(labels, 8, 8).astype(np.float32)
    hi, ti = rng.randint(0, 9, 11), rng.randint(0, 9, 11)
    lb = rng.randint(0, labels, 11)
    jm = JBilinear(num_labels=labels, input_dim1=8, input_dim2=8)
    jv = {"params": {"weight": jnp.asarray(w)}}

    def jax_scores(zz):
        return jm.apply(jv, zz, jnp.asarray(hi), jnp.asarray(ti),
                        jnp.asarray(lb), chunk,
                        method=JBilinear.triples_indexed)

    want = jax_scores(jnp.asarray(z))
    want_grad = jax.grad(lambda zz: jnp.sum(jax_scores(zz) ** 2))(
        jnp.asarray(z))
    tm = BilinearDDIScorer(labels, 8, 8)
    tm.load_state_dict({"weight": torch.from_numpy(w)})
    zt = torch.from_numpy(z).requires_grad_()
    got = tm.triples_indexed(zt, torch.from_numpy(hi), torch.from_numpy(ti),
                             torch.from_numpy(lb), chunk=chunk)
    (got ** 2).sum().backward()
    assert_close_to_largest(got.detach().numpy(), want)
    assert_close_to_largest(zt.grad.numpy(), want_grad)
    pairs = jm.apply(jv, jnp.asarray(z[hi]), jnp.asarray(z[ti]),
                     method=JBilinear.pairs_all_labels)
    with torch.no_grad():
        got = tm.pairs_all_labels(torch.from_numpy(z[hi]),
                                  torch.from_numpy(z[ti]))
    assert_close_to_largest(got.numpy(), pairs)


# ---------------------------------------------------------------- data
def test_remove_edges_attached_to_drugs_matches_jax():
    _, edges = small_kg(np.random.RandomState(0))
    want = j_kg.remove_edges_attached_to_drugs(edges, np.array([0, 1]), 10)
    got = t_kg.remove_edges_attached_to_drugs(edges, np.array([0, 1]), 10)
    assert list(got) == list(want)
    for et in want:
        np.testing.assert_array_equal(got[et], want[et])
        if et[0] == "drug":
            assert not np.isin(got[et][0], [0, 1]).any()
        if et[2] == "drug":
            assert not np.isin(got[et][1], [0, 1]).any()
    assert sum(e.shape[1] for e in got.values()) < sum(
        e.shape[1] for e in edges.values())


def link_split(ds, module):
    num_nodes = {k: v.shape[0] for k, v in ds.kg_node_feats.items()}
    trainer = module.HGTLinkPredTrainer
    return trainer.make_link_split(ds.kg_edge_indices,
                                   np.random.RandomState(0), num_nodes)


def test_make_link_split_matches_jax(data):
    dj, dt = data
    qj, lj, mj = link_split(dj, j_mp)
    qt, lt, mt = link_split(dt, t_mp)
    assert [q[:2] for q in qt] == [q[:2] for q in qj]
    for a, b in zip(qt, qj):
        np.testing.assert_array_equal(a[2], np.asarray(b[2]))
        np.testing.assert_array_equal(a[3], np.asarray(b[3]))
    np.testing.assert_array_equal(lt, np.asarray(lj))
    assert list(mt) == list(mj)
    for et in mj:
        np.testing.assert_array_equal(mt[et], mj[et])
    assert lt.sum() == sum(e.shape[1] for e in dt.kg_edge_indices.values()
                           ) - sum(e.shape[1] for e in mt.values())


# ------------------------------------------------------------ trainers
@pytest.fixture(scope="module")
def gin_run(data):
    dj, dt = data
    cj, ct = configs(j_config), configs(t_config)
    rng = np.random.RandomState(1)
    labels = (rng.rand(DATA["num_drugs"], 5) < 0.3).astype(np.float32)
    mask = (rng.rand(DATA["num_drugs"], 5) < 0.9).astype(np.float32)
    bj = j_pack(dj.molecules)
    bt = t_pack(dt.molecules, device="cpu")
    jt = j_mp.GINPretrainer(cj["gin"], FEAT, 5, lr=LR)
    v = jt.model.init(jax.random.PRNGKey(0), bj, train=False)
    jt._vars = {"params": v["params"], "batch_stats": v["batch_stats"]}
    jt._opt = jt.tx.init(jt._vars["params"])
    tt = t_mp.GINPretrainer(ct["gin"], FEAT, 5, lr=LR, device="cpu")
    tt.model.load_state_dict(from_flax.gin_property_state_dict(
        np_vars(jt._vars)))
    run = run_steps(jt, tt, lambda: jt.train_step(bj, labels, mask),
                    lambda: tt.train_step(bt, labels, mask))
    return jt, tt, run


@pytest.fixture(scope="module")
def hgt_run(data):
    """Both sides score the queries in chunks of 64 (checkpointed)."""
    dj, dt = data
    cj, ct = configs(j_config), configs(t_config)
    qj, lj, mj = link_split(dj, j_mp)
    qt, lt, mt = link_split(dt, t_mp)
    kj = j_kg.build_kg_batch(dj.kg_node_feats, mj, dj.kg_drug_ids)
    kt = t_kg.build_kg_batch(dt.kg_node_feats, mt, dt.kg_drug_ids,
                             device="cpu", src_sort=True)
    assert len(lt) > 64
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBilinear, "INDEXED_CHUNK", 64)
        mp.setattr(BilinearDDIScorer, "INDEXED_CHUNK", 64)
        jt = j_mp.HGTLinkPredTrainer(cj["hgt"], FEAT, lr=LR)
        v = jt.model.init(jax.random.PRNGKey(0), kj, qj, train=False)
        jt._vars = {"params": v["params"]}
        jt._opt = jt.tx.init(jt._vars["params"])
        tt = t_mp.HGTLinkPredTrainer(
            ct["hgt"], FEAT, *t_kg.kg_schema(dt.kg_node_feats, mt), lr=LR,
            device="cpu")
        tt.model.load_state_dict(from_flax.hgt_link_pred_state_dict(
            np_vars(jt._vars)))
        run = run_steps(jt, tt, lambda: jt.train_step(kj, qj, lj),
                        lambda: tt.train_step(kt, qt, lt))
    return jt, tt, run


@pytest.fixture(scope="module")
def ae_run(data):
    _, dt = data
    x = dt.cv_table[:12]
    jt = j_mp.TabularAETrainer(x.shape[1], (32, 16), FEAT, lr=LR)
    jt.model = j_mp.TabularAE(input_dim=x.shape[1], hidden_dims=(32, 16),
                              latent_dim=FEAT, dropout=0.0)
    jt._vars = {"params": jt.model.init(jax.random.PRNGKey(0),
                                        jnp.asarray(x))["params"]}
    jt._opt = jt.tx.init(jt._vars["params"])
    tt = t_mp.TabularAETrainer(x.shape[1], (32, 16), FEAT, lr=LR,
                               device="cpu", dropout=0.0)
    assert tt.model.dropout == 0.0
    tt.model.load_state_dict(from_flax.tabular_ae_state_dict(
        np_vars(jt._vars)))
    run = run_steps(jt, tt, lambda: jt.train_step(x),
                    lambda: tt.train_step(x))
    return jt, tt, run


def chemcpa_inputs(n=24, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 30).astype(np.float32), rng.randint(0, 4, n),
            rng.randint(0, 6, n), rng.rand(n).astype(np.float32))


@pytest.fixture(scope="module", params=[True, False],
                ids=["disable_adv", "adversaries"])
def chemcpa_run(request):
    disable_adv = request.param
    genes, cov, drugs, doses = chemcpa_inputs()
    jt = j_mp.ChemCPAAdaptTrainer(configs(j_config)["chemcpa"](disable_adv),
                                  lr=LR, adversary_lr=LR)
    jt._init(jnp.asarray(genes), jnp.asarray(cov), jnp.asarray(drugs),
             jnp.asarray(doses))
    tt = t_mp.ChemCPAAdaptTrainer(configs(t_config)["chemcpa"](disable_adv),
                                  lr=LR, adversary_lr=LR, device="cpu")
    tt.model.load_state_dict(from_flax.chemcpa_adapt_state_dict(
        np_vars(jt._vars)))
    run = run_steps(jt, tt, lambda: jt.train_step(genes, cov, drugs, doses),
                    lambda: tt.train_step(genes, cov, drugs, doses), steps=4)
    return jt, tt, run


def test_gin_trainer_three_steps_match_jax(gin_run):
    jt, tt, run = gin_run
    assert_steps_match(jt._vars, tt, run)
    assert any(k.endswith("running_var") for k in tt.encoder_params())
    assert not any(k.startswith("head") for k in tt.encoder_params())


def test_hgt_link_pred_three_steps_match_jax(hgt_run):
    jt, tt, run = hgt_run
    assert_steps_match(jt._vars, tt, run)
    heads = {k.split(".")[0] for k in tt.encoder_params()
             if k.startswith("lin__")}
    assert heads == {f"lin__{nt}" for nt in ("disease", "drug", "protein")}


def test_tabular_ae_three_steps_match_jax(ae_run):
    jt, tt, run = ae_run
    assert_steps_match(jt._vars, tt, run)


def test_chemcpa_adaptation_four_steps_match_jax(chemcpa_run):
    jt, tt, run = chemcpa_run
    lj, lt, _, before = run
    kinds = [next(iter(x)) for x in lt]
    assert kinds == [next(iter(x)) for x in lj]
    if tt.cfg.disable_adv:
        assert kinds == ["loss_reconstruction"] * 4
        assert tt.adv_optimizer is None
    else:  # iteration 0 runs the adversary step
        assert kinds == ["loss_adv", "loss_reconstruction"] * 2
    assert_steps_match(jt._vars, tt, run, steps=4)
    sd = tt.encoder_variables()
    assert torch.equal(sd["drug_embeddings.weight"],
                       before["drug_embeddings.weight"])
    assert any(k.startswith("adversary_drugs.") for k in sd) == (
        not tt.cfg.disable_adv)


# -------------------------------------------------------------- chemCPA
def test_reconstruct_and_nll_match_jax(chemcpa_run):
    jt, _, _ = chemcpa_run
    genes, cov, drugs, doses = chemcpa_inputs(n=10, seed=5)
    cfg = configs(t_config)["chemcpa"](jt.cfg.disable_adv)
    tm = t_chemcpa.ChemCPAEncoder(cfg, adaptation=True)
    tm.load_state_dict(from_flax.chemcpa_adapt_state_dict(np_vars(jt._vars)))
    jm = j_chemcpa.ChemCPAEncoder(cfg=jt.cfg)
    args = [jnp.asarray(a) for a in (genes, cov, drugs, doses)]
    targs = [torch.from_numpy(a) for a in (genes, cov, drugs, doses)]
    for train in (False, True):
        tm.train(train)
        (mean, var), upd = jm.apply(jt._vars, *args, train=train,
                                    mutable=["batch_stats"],
                                    method=j_chemcpa.ChemCPAEncoder.reconstruct)
        with torch.no_grad():
            tmean, tvar = tm.reconstruct(*targs)
        np.testing.assert_allclose(tmean.numpy(), np.asarray(mean),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tvar.numpy(), np.asarray(var), rtol=1e-5,
                                   atol=1e-5)
        want = j_chemcpa.gaussian_nll_loss(mean, var, args[0])
        got = t_chemcpa.gaussian_nll_loss(tmean, tvar, targs[0])
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k, ref in state_dict_of({"batch_stats": upd["batch_stats"]}).items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), ref.numpy(),
                                   atol=1e-5, err_msg=k)
    # a variance below eps is clamped on both sides
    m, v, y = (np.random.RandomState(7).rand(3, 5).astype(np.float32)
               for _ in range(3))
    v[0, :2] = 0.0
    np.testing.assert_allclose(
        float(t_chemcpa.gaussian_nll_loss(*map(torch.from_numpy, (m, v, y)))),
        float(j_chemcpa.gaussian_nll_loss(m, v, y)), rtol=1e-6)
    # the encoder stages 2 and 3 build holds only the predict path
    plain = set(t_chemcpa.ChemCPAEncoder(cfg).state_dict())
    assert not any(k.startswith(("decoder.", "adversary")) for k in plain)
    assert plain < set(tm.state_dict())


def test_evaluations_match_jax(chemcpa_run):
    """On the JAX trainer's trained weights, loaded into the port's."""
    jt, tt, _ = chemcpa_run
    tt.model.load_state_dict(from_flax.chemcpa_adapt_state_dict(
        np_vars(jt._vars)))
    rng = np.random.RandomState(11)
    n = 40
    genes = (np.abs(rng.randn(n, 30)) + 0.5).astype(np.float32)
    cov = rng.randint(0, 2, n)
    drugs = rng.randint(0, 6, n)
    doses = rng.rand(n).astype(np.float32)
    ctrl = (np.abs(rng.randn(24, 30)) + 0.5).astype(np.float32)
    ctrl_cov = rng.randint(0, 2, 24)
    cats = np.array([f"cell{c}_drugA_1.0" for c in cov])
    cats[:3] = "cell0_DMSO_0.0"
    de = {c: np.array([0, 2, 4]) for c in np.unique(cats)}

    def both(name, *args, **kw):
        return (getattr(t_mp, name)(tt, *args, **kw),
                getattr(j_mp, name)(jt, *args, **kw))

    got, want = both("evaluate_r2_tx_adapting", genes, cov, drugs, doses)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for kw in (dict(de_gene_idx=de), {}):
        got, want = both("evaluate_r2_per_category", genes, cov, ctrl, cats,
                         drugs, doses, **kw)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    got, want = both("evaluate_logfold_r2", genes, cov, ctrl, ctrl_cov, cats,
                     drugs, doses)
    assert np.isfinite(want[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # no category above min_count: nan on both sides
    for name, args in (("evaluate_r2_per_category", (ctrl, cats[:4])),
                       ("evaluate_logfold_r2", (ctrl, ctrl_cov, cats[:4]))):
        got, want = both(name, genes[:4], cov[:4], *args)
        got = got["mean_score"] if isinstance(got, dict) else got[0]
        want = want["mean_score"] if isinstance(want, dict) else want[0]
        assert np.isnan(got) and np.isnan(want)

    # the probe: the covariate leaks into genes[:, 0]
    leak = rng.randn(64, 30).astype(np.float32) * 0.05
    c = rng.randint(0, 2, 64)
    leak[:, 0] += c * 3.0
    labels = {"covariate": c, "constant": np.zeros(64, int)}
    got, want = both("evaluate_disentanglement", leak, labels, epochs=60)
    assert got.keys() == want.keys()
    for k in labels:
        assert got[k + "_optimal"] == want[k + "_optimal"], k
        assert 0.0 <= got[k] <= 1.0
    assert got["covariate"] > 0.9 and want["covariate"] > 0.9
    assert got["constant"] == want["constant"] == 1.0


# ------------------------------------------------------------- transfer
def to_flax(module: nn.Module):
    """A port module's (params, batch_stats) as flax trees: the inverse of
    interop.from_flax.flax_to_state_dict (checked by a round trip)."""
    params, stats = {}, {}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = value

    for name, mod in module.named_modules():
        path = name.split(".") if name else []
        for n, p in mod.named_parameters(recurse=False):
            v, leaf = p.detach().numpy().copy(), n
            if isinstance(mod, nn.Linear) and n == "weight":
                v, leaf = v.T.copy(), "kernel"
            elif isinstance(mod, nn.Embedding):
                leaf = "embedding"
            elif isinstance(mod, (MaskedBatchNorm, nn.LayerNorm)) and (
                    n == "weight"):
                leaf = "scale"
            put(params, path + [leaf], v)
        for n, b in mod.named_buffers(recurse=False):
            if n in ("running_mean", "running_var"):
                put(stats, path + [n[len("running_"):]], b.numpy().copy())
    sd = from_flax.flax_to_state_dict({"params": params,
                                       "batch_stats": stats})
    assert sd.keys() == module.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in module.state_dict().items())
    return params, stats


@pytest.fixture(scope="module")
def stage2_encoder(data):
    """A port stage-2 encoder whose modules take the trainers' encoders."""
    _, dt = data
    c = configs(t_config)
    enc = t_config.EncoderConfig(
        feature_dim=FEAT, gin=c["gin"], hgt=c["hgt"],
        cv=t_config.MLPEncoderConfig(hidden_dims=(32, 16)),
        chemcpa=c["chemcpa"](False),
        transformer=t_config.FusionConfig(num_layers=1, att_heads=2,
                                          head_dim=8, ffn_dim=32))
    model = MadrigalEncoder(enc, *t_kg.kg_schema(dt.kg_node_feats,
                                                 dt.kg_edge_indices))
    return init_weights(model, torch.Generator().manual_seed(0))


def load_jax_weights(*runs):
    for jt, tt, _ in runs:
        tt.model.load_state_dict(state_dict_of(jt._vars))


def jax_checkpoints(gin_run, hgt_run, ae_run, chemcpa_run):
    """The four trees the JAX stage-1 CLI saves, by modality."""
    p, s = gin_run[0].encoder_params()
    tx = chemcpa_run[0].encoder_variables()
    return {"str": {"params": {"str_encoder": p},
                    "batch_stats": {"str_encoder": s}},
            "kg": {"params": {"kg_encoder": hgt_run[0].encoder_params()},
                   "batch_stats": {}},
            "cv": {"params": {"cv_encoder": ae_run[0].encoder_params()},
                   "batch_stats": {}},
            "tx": {"params": {"tx_encoder": tx["params"]},
                   "batch_stats": {"tx_encoder": tx["batch_stats"]}}}


def test_overlay_stage1_checkpoint_matches_jax(stage2_encoder, gin_run,
                                               hgt_run, ae_run, chemcpa_run,
                                               tmp_path):
    """Through the weight bridge: the JAX CLI's trees written as port
    checkpoints (`stage1_checkpoint_from_flax`), overlaid one by one."""
    jp, js = to_flax(stage2_encoder)
    got = stage2_encoder.state_dict()
    cfgs = {"str": configs(t_config)["gin"], "kg": configs(t_config)["hgt"],
            "cv": t_config.MLPEncoderConfig(hidden_dims=(32, 16)),
            "tx": chemcpa_run[1].cfg}
    for mod, tree in jax_checkpoints(gin_run, hgt_run, ae_run,
                                     chemcpa_run).items():
        tree = np_vars(tree)
        jp, js = j_transfer.overlay_stage1_checkpoint(jp, js, tree)
        path = str(tmp_path / f"{mod}_pretrained")
        from_flax.stage1_checkpoint_from_flax(tree, path, cfgs[mod])
        sd, cfg = load_checkpoint(path)
        assert cfg == cfgs[mod]
        got = t_transfer.overlay_stage1_checkpoint(got, sd)
    want = from_flax.flax_to_state_dict({"params": jp, "batch_stats": js})
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    fresh = stage2_encoder.state_dict()
    changed = {k.split(".")[0] for k in got if not torch.equal(got[k],
                                                               fresh[k])}
    assert changed == {"str_encoder", "kg_encoder", "cv_encoder",
                       "tx_encoder"}
    with pytest.raises(KeyError, match="not in encoder"):
        t_transfer.overlay_stage1_checkpoint(fresh, {"gat_encoder.w": sd[
            next(iter(sd))]})


def test_encoder_params_from_stage1_matches_jax(stage2_encoder, gin_run,
                                                hgt_run, ae_run,
                                                chemcpa_run):
    """The same weights on both sides (the JAX trainers' loaded into the
    port's). The JAX result also holds the chemCPA decoder's statistics,
    which the encoder never reads and the port cannot hold."""
    load_jax_weights(gin_run, hgt_run, ae_run, chemcpa_run)
    jp, js = to_flax(stage2_encoder)
    jp, js = j_transfer.encoder_params_from_stage1(
        jp, js, *(r[0] for r in (gin_run, hgt_run, ae_run, chemcpa_run)))
    want = from_flax.flax_to_state_dict(np_vars({"params": jp,
                                                 "batch_stats": js}))
    got = t_transfer.encoder_params_from_stage1(
        stage2_encoder.state_dict(),
        *(r[1] for r in (gin_run, hgt_run, ae_run, chemcpa_run)))
    extra = set(want) - set(got)
    assert extra and all(k.startswith("tx_encoder.decoder.bn_")
                         for k in extra)
    assert set(got) <= set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["kg_encoder.lin__drug.weight"],
                       hgt_run[1].encoder_params()["lin__drug.weight"])
