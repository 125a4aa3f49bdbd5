"""Stage 2 (contrastive pretraining) in the port against the JAX package.

  * `SimCLRPredictor` in train and eval mode, the BatchNorm statistics
    after a train-mode call included, and `SimCLRModel`'s views and loss
    on the device-table (`ids`) and the host-collate path, from the JAX
    model's variables carried across with `interop/from_flax` (atol 1e-5:
    the same f32 math summed in another order; the logits, similarities
    over the temperature, within 1e-5 of a similarity). At eval mode the
    two paths give the same loss.
  * The `pretrain_masks` copy gives the JAX module's banks and draws
    exactly, for every pretrain mode, balanced and unbalanced.
  * `CLPretrainer` over 4 steps against the JAX `CLPretrainer` from the
    same weights (dropout 0): the device-table path under AdamW (with the
    frozen chemCPA drug table) and under LARS, and the host-collate path
    under AdamW. The host draws are equal exactly, the losses within
    1e-5 relative, and every parameter and BatchNorm statistic within
    1e-5 of JAX's, except under AdamW the entries whose step-1 gradient
    is rounding noise (at most 1e-6 of the model's largest; an attention
    key bias, a bias ahead of a BatchNorm): Adam's 1/sqrt(v) turns that
    noise into an update of up to the learning rate either way, so those
    are held to twice the schedule's summed rate more, and so are the
    running means, which follow such a bias ahead of their BatchNorm.
    Most tensors move by more than twice the tolerance.
    `train_steps` gives `train_step`'s losses; the spans recording under
    torch.profiler leave two steps' losses and weights as they are, bit
    for bit.
  * The prefetcher keeps order and raises a worker's exception after the
    batches before it.
  * The CLI: `--resume` from `cl_checkpoint_k` ends where the straight run
    ends, `--final_embeds_eval` writes the JAX CLI's files,
    `--modality_ckpts` overlays the stage-1 checkpoints exactly, and
    `train_ddi --checkpoint <cl_last>`
    starts from the stage-2 encoder parameters.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.models.mlp import SimCLRPredictor as JPredictor
from madrigal_tpu.train import pretrain_cl as j_pcl
from madrigal_tpu.train import pretrain_masks as j_masks
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.cli import pretrain as t_pre_cli
from madrigal_tpu_torch.cli import train_ddi as t_cli
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.data.pipeline import DevicePrefetcher, prefetch_epochs
from madrigal_tpu_torch.interop.from_flax import (
    flax_to_state_dict,
    load_flax_weights,
)
from madrigal_tpu_torch.models.mlp import SimCLRPredictor
from madrigal_tpu_torch.train import pretrain_cl as t_pcl
from madrigal_tpu_torch.train import pretrain_masks as t_masks
from madrigal_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_train_state,
)
from test_torch_train import one_thread  # noqa: F401  (fixture)

DATA = dict(num_drugs=14, num_labels=4, num_edges=20, seed=3)
TOL = dict(atol=1e-5, rtol=1e-5)


def tiny_pretrain_cfg(c, **kw):
    """tests/test_pretrain.py's encoder with dropout 0."""
    enc = c.EncoderConfig(
        feature_dim=16,
        gin=c.GINConfig(hidden_dims=(16, 16), num_mlp_layer=2),
        hgt=c.HGTConfig(hidden_dim=8, num_layers=2, att_heads=2),
        cv=c.MLPEncoderConfig(hidden_dims=(32, 16), dropout=0.0),
        chemcpa=c.ChemCPAConfig(dim=16, autoencoder_width=32,
                                autoencoder_depth=1,
                                use_drugs=kw.pop("use_drugs", False),
                                num_drugs=DATA["num_drugs"]),
        transformer=c.FusionConfig(num_layers=1, att_heads=2, head_dim=8,
                                   ffn_dim=32, dropout=0.0, norm_first=True,
                                   agg="x-attn", num_tx_bottlenecks=2),
        proj=c.ProjectorConfig(hidden_dims=(32, 32), dropout=0.0),
        pos_emb_type="sinusoidal", pos_emb_dropout=0.0,
    )
    base = dict(encoder=enc, pretrain_mode="str_center_uni",
                pretrain_unbalanced=True, raw_encoder_output=True,
                pretrain_batch_size=8, pretrain_num_epochs=20,
                warmup_epochs=2, pretrain_lr=1e-3)
    base.update(kw)
    return c.PretrainConfig(**base)


@pytest.fixture(scope="module")
def data():
    dj, dt = j_syn.make_dataset(**DATA), t_syn.make_dataset(**DATA)
    cj = j_collate.DDICollator(dj, split="train")
    ct = t_collate.DDICollator(dt, split="train", device="cpu",
                               kg_src_sort=True)
    return dt, cj, cj.kg_batch(), ct, ct.kg_batch()


def variables_of(jt):
    """A JAX trainer's variables, as numpy."""
    return jax.tree_util.tree_map(np.asarray, {
        "params": jt.state.params, "batch_stats": jt.state.batch_stats})


# the trainer runs held to JAX: (device_table, optimizer) -> config
# arguments. The host-collate run takes every drug each step, so that the
# JAX step compiles once.
RUNS = {(True, "adamw"): dict(use_drugs=True),
        (True, "lars"): dict(pretrain_optimizer="lars", pretrain_lr=0.5,
                             warmup_epochs=1),
        (False, "adamw"): dict(pretrain_batch_size=64)}


def jax_trainer(data, device_table, optimizer):
    _, cj, kj, _, _ = data
    return j_pcl.CLPretrainer(
        tiny_pretrain_cfg(j_config, **RUNS[device_table, optimizer]), cj,
        kj, device_table=device_table)


def port_trainer(data, device_table, optimizer, variables=None):
    """The port's trainer of a RUNS entry, holding `variables` (a JAX
    model's) or, without them, weights from seed 0."""
    from madrigal_tpu_torch.models.encoder import init_weights

    dt, _, _, ct, kt = data
    cfg = tiny_pretrain_cfg(t_config, **RUNS[device_table, optimizer])
    model = t_pcl.build_simclr_model(
        cfg, *kg_schema(dt.kg_node_feats, dt.kg_edge_indices))
    if variables is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        load_flax_weights(model, variables)
    return t_pcl.CLPretrainer(cfg, ct, kt, model, device_table=device_table)


@pytest.fixture(scope="module")
def ref(data):
    """The JAX device-table AdamW trainer, built once, and its initial
    variables."""
    jt = jax_trainer(data, True, "adamw")
    return jt, variables_of(jt)


# ------------------------------------------------------------- modules
def test_predictor_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(10, 16).astype(np.float32)
    jm = JPredictor(mlp_dim=24, output_dim=16)
    v = jm.init(jax.random.PRNGKey(0), x)
    v = {"params": v["params"], "batch_stats": {
        k: {"mean": rng.randn(*s["mean"].shape).astype(np.float32),
            "var": rng.uniform(0.5, 2, s["var"].shape).astype(np.float32)}
        for k, s in v["batch_stats"].items()}}
    tm = load_flax_weights(SimCLRPredictor(16, 24, 16), v)
    assert tm.bn_1.weight is None  # the last BatchNorm has no affine
    want = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stats = flax_to_state_dict({"batch_stats": upd["batch_stats"]})
    for k, ref in stats.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), ref.numpy(),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("path,train", [("ids", True), ("ids", False),
                                        ("host", True)])
def test_simclr_model_matches_jax(data, ref, path, train):
    """Train mode (batch statistics, updated running ones) and eval mode
    on the ids path, train mode on the host-collate path."""
    jt, init = ref
    tt = port_trainer(data, True, "adamw", init)
    ids = np.array([3, 0, 7, 11, 5, 2, 9, 13], np.int32)
    m1, m2 = tt._sample_masks(ids)  # the shared JAX trainer's draws stay
    _, _, _, ct, kt = data
    if path == "ids":
        jb, tb = jt.full_batch, tt.full_batch
        jkw, tkw = {"ids": jnp.asarray(ids)}, {"ids": torch.from_numpy(ids)}
    else:
        jb, tb = jt.collator.drug_batch(ids), ct.drug_batch(ids)
        jkw, tkw = {}, {}
    (a1, a2, (lg, _, loss)), upd = jt.model.apply(
        init, jb, jt.kg, jnp.asarray(m1), jnp.asarray(m2), train=train,
        mutable=["batch_stats"], **jkw)
    tt.model.train(train)
    with torch.no_grad():
        b1, b2, (tl, _, tloss) = tt.model(
            tb, kt, torch.from_numpy(m1), torch.from_numpy(m2), **tkw)
    for got, want in ((b1, a1), (b2, a2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the logits are cosine similarities over the temperature: 1e-5 of a
    # similarity
    np.testing.assert_allclose(tl.numpy(), np.asarray(lg), rtol=0,
                               atol=1e-5 / tt.model.temperature)
    np.testing.assert_allclose(float(tloss), float(loss), **TOL)
    want = flax_to_state_dict({"batch_stats": upd["batch_stats"]})
    sd = tt.model.state_dict()
    for k, r in want.items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), err_msg=k,
                                   **TOL)


def test_ids_path_equals_host_path_in_eval_mode(data):
    tt = port_trainer(data, True, "adamw")
    _, _, _, ct, kt = data
    ids = np.array([3, 0, 7, 11, 5, 2, 9, 13])
    m1, m2 = map(torch.from_numpy, tt._sample_masks(ids))
    tt.model.eval()
    with torch.no_grad():
        loss_ids = tt.model(tt.full_batch, kt, m1, m2,
                            ids=torch.from_numpy(ids))[2][2]
        loss_host = tt.model(ct.drug_batch(ids), kt, m1, m2)[2][2]
    np.testing.assert_allclose(float(loss_ids), float(loss_host), atol=1e-5)


@pytest.mark.parametrize("unbalanced", [True, False])
@pytest.mark.parametrize("mode", t_config.PRETRAIN_MODES)
def test_pretrain_masks_copy_matches_jax(mode, unbalanced):
    masks = t_syn.make_dataset(num_drugs=40, seed=5).masks
    # str plus at least 2 other modalities: every mode's bank is non-empty
    drugs = np.where((~masks[:, 1:]).sum(1) >= 2)[0]
    jb = j_masks.get_pretrain_masks(drugs, masks[drugs], mode, unbalanced,
                                    0.4)
    tb = t_masks.get_pretrain_masks(drugs, masks[drugs], mode, unbalanced,
                                    0.4)
    assert jb.keys() == tb.keys()
    for d in jb:
        pairs = [(jb[d], tb[d])] if unbalanced else zip(jb[d], tb[d])
        for a, b in pairs:
            np.testing.assert_array_equal(a, b)
    jr, tr = np.random.RandomState(1), np.random.RandomState(1)
    for _ in range(3):
        got = t_masks.sample_pretrain_masks(tb, drugs, mode, unbalanced, tr,
                                            masks.shape[1])
        want = j_masks.sample_pretrain_masks(jb, drugs, mode, unbalanced,
                                             jr, masks.shape[1])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- trainer
def record_draws(trainer):
    """Wrap a trainer's mask sampler; returns the list of (drug ids, m1,
    m2) it draws from then on."""
    draws, orig = [], trainer._sample_masks

    def wrapped(drugs):
        out = orig(drugs)
        draws.append((np.array(drugs), *out))
        return out

    trainer._sample_masks = wrapped
    return draws


@pytest.mark.parametrize("device_table,optimizer", list(RUNS))
def test_trainer_four_steps_match_jax(data, ref, device_table, optimizer):
    if (device_table, optimizer) == (True, "adamw"):
        jt, init = ref
    else:
        jt = jax_trainer(data, device_table, optimizer)
        init = variables_of(jt)
    tt = port_trainer(data, device_table, optimizer, init)
    use_drugs = RUNS[device_table, optimizer].get("use_drugs", False)
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    jd, td = record_draws(jt), record_draws(tt)
    lj, lt, grads = [], [], None
    for step in range(4):
        lj.append(jt.train_step())
        lt.append(tt.train_step())
        if step == 0:
            grads = {k: p.grad.clone() for k, p in
                     tt.model.named_parameters() if p.grad is not None}
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert len(jd) == len(td) == 4
    for a, b in zip(jd, td):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(jt.np_rng.get_state()[1:3], tt.np_rng.get_state()[1:3]):
        np.testing.assert_array_equal(a, b)

    want = flax_to_state_dict(variables_of(jt))
    got = tt.model.state_dict()
    top = max(float(g.abs().max()) for g in grads.values())
    lrs = sum(tt.scheduler.base_lrs[0] * tt.scheduler.lr_lambdas[0](s)
              for s in range(4))
    noisy = big = 0
    for k, ref in want.items():
        atol = np.full(ref.shape, 1e-5)
        if optimizer == "adamw" and k in grads:
            # an exact 0 on one side may be rounding noise on the other
            g = grads[k].abs()
            atol[(g <= 1e-6 * top).numpy()] += 2 * lrs
            noisy += int(((g > 0) & (g <= 1e-6 * top)).sum())
        elif optimizer == "adamw" and k.endswith("running_mean"):
            # a BatchNorm's running mean follows a bias ahead of it
            atol += 2 * lrs
        err = np.abs(got[k].numpy() - ref.numpy())
        assert (err <= atol).all(), (k, float(err.max()))
        big += float((ref - before[k]).abs().max()) > 2e-5
    # the updates are larger than the tolerance, and noise is rare
    assert big > len(want) // 2
    assert noisy < 0.05 * sum(v.numel() for v in want.values())
    frozen = [k for k in got if t_pcl.is_frozen(k)]
    assert bool(frozen) == use_drugs
    for k in frozen:
        assert torch.equal(got[k], before[k]), k


def test_train_steps_equal_train_step(data):
    a, b = (port_trainer(data, True, "adamw") for _ in range(2))
    np.testing.assert_allclose(b.train_steps(3, buffer_size=1),
                               [a.train_step() for _ in range(3)],
                               rtol=1e-6)
    for k, v in a.model.state_dict().items():
        np.testing.assert_allclose(b.model.state_dict()[k].numpy(),
                                   v.numpy(), atol=1e-6, err_msg=k)
    enc = a.encoder_state_dict()
    assert {"base_encoder." + k for k in enc} == {
        k for k in a.model.state_dict() if k.startswith("base_encoder.")}


def test_spans_leave_the_step_bit_for_bit(data):
    """Two steps with the port's spans recording under torch.profiler
    give the losses and weights of two steps without, bit for bit."""
    from madrigal_tpu_torch.utils import profiling

    a, b = (port_trainer(data, True, "adamw") for _ in range(2))
    a.train_step()  # untraced in both runs
    b.train_step()
    plain = [a.train_step() for _ in range(2)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = [b.train_step() for _ in range(2)]
    assert [r.name for r in profiling.recorded()].count(
        "madrigal.optimizer") == 2
    assert plain == traced
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k


def test_prefetcher_order_and_errors():
    out = list(prefetch_epochs(lambda s: {"x": np.full(3, s), "s": s}, 5,
                               buffer_size=2, device="cpu"))
    assert [o["s"] for o in out] == list(range(5))
    assert all(torch.equal(o["x"], torch.full((3,), o["s"])) for o in out)

    def failing():
        yield (np.zeros(2),)
        raise ValueError("worker failed")

    got = []
    with pytest.raises(ValueError, match="worker failed"):
        for batch in DevicePrefetcher(failing(), device="cpu"):
            got.append(batch)
    assert len(got) == 1


# ------------------------------------------------------------------- CLI
CLI_ARGS = ["--platform", "cpu", "--synthetic", "--synthetic_drugs", "16",
            "--synthetic_labels", "4", "--synthetic_edges", "16",
            "--batch_size", "8",
            "--set", "encoder.feature_dim=16",
            "--set", "encoder.gin.hidden_dims=[16,16]",
            "--set", "encoder.gin.num_mlp_layer=2",
            "--set", "encoder.hgt.hidden_dim=8",
            "--set", "encoder.hgt.att_heads=2",
            "--set", "encoder.cv.hidden_dims=[32,16]",
            "--set", "encoder.cv.dropout=0.0",
            "--set", "encoder.chemcpa.dim=16",
            "--set", "encoder.chemcpa.autoencoder_width=32",
            "--set", "encoder.chemcpa.autoencoder_depth=1",
            "--set", "encoder.transformer.num_layers=1",
            "--set", "encoder.transformer.att_heads=2",
            "--set", "encoder.transformer.head_dim=8",
            "--set", "encoder.transformer.ffn_dim=32",
            "--set", "encoder.transformer.dropout=0.0",
            "--set", "encoder.proj.hidden_dims=[32,32]",
            "--set", "encoder.proj.dropout=0.0",
            "--set", "encoder.pos_emb_dropout=0.0",
            "--set", "warmup_epochs=2"]


def test_cli_resume_ends_where_the_straight_run_ends(tmp_path):
    """str_kg draws nothing on the host and a batch of every drug
    chooses none, so the resumed run (its draws restarted from the seed)
    sees the straight run's batches: the same losses (rtol 1e-5) and
    weights (atol 6 * lr: the CPU's threaded sums are not bitwise
    repeatable, and Adam turns that noise on a near-zero gradient into an
    update of up to lr a step)."""
    argv = CLI_ARGS + ["--pretrain_mode", "str_kg", "--batch_size", "16",
                       "--num_steps", "7", "--save_checkpoints", "3"]
    straight = t_pre_cli.main(argv + ["--save_dir", str(tmp_path / "a")])
    assert [os.path.basename(p) for p in straight["checkpoints"]] == [
        "cl_checkpoint_3", "cl_checkpoint_6"]
    assert straight["segment_steps"] == [4, 3]
    epoch, _, extra = load_train_state(straight["checkpoints"][0])
    assert (epoch, extra["steps"]) == (3, 4)
    resumed = t_pre_cli.main(argv + ["--resume", straight["checkpoints"][0],
                                     "--save_dir", str(tmp_path / "b")])
    np.testing.assert_allclose(resumed["losses"], straight["losses"][4:],
                               rtol=1e-5)
    sd_a, cfg = load_checkpoint(straight["checkpoint"])
    sd_b, _ = load_checkpoint(resumed["checkpoint"])
    assert cfg.pretrain_mode == "str_kg" and cfg.save_checkpoints == 3
    lr = 1e-4 * 16 / 512
    for k in sd_a:
        np.testing.assert_allclose(sd_b[k].numpy(), sd_a[k].numpy(),
                                   atol=6 * lr, rtol=0, err_msg=k)
    with open(tmp_path / "a" / "pretrain_metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["_step"] for r in records] == list(range(7))
    np.testing.assert_allclose([r["cl_loss"] for r in records],
                               straight["losses"], rtol=1e-6)
    assert "step 0: infonce=" in (tmp_path / "a" / "pretrain.log").read_text()


def test_cli_final_embeds_eval_writes_the_jax_files(tmp_path):
    """The files of tests/test_evaluate_pt.py's JAX CLI test, and an
    embedding table per (split, modality) with its drugs and masks."""
    save = tmp_path / "cl"
    res = t_pre_cli.main(CLI_ARGS + ["--num_steps", "2", "--host_collate",
                                     "--final_embeds_eval",
                                     "--save_dir", str(save)])
    assert (save / "final_embeds_metrics.json").exists()
    assert (save / "final_embeds").is_dir()
    with open(save / "final_embeds_metrics.json") as f:
        table = json.load(f)
    assert table.keys() == res["final_embeds"].keys()
    assert any(k.startswith("train 0 v ") for k in table)
    emb = np.load(save / "final_embeds" / "train_embeds_0.npz")
    assert set(emb.files) == {"embeds", "drugs", "masks"}
    assert emb["embeds"].shape == (len(emb["drugs"]), 16)


def test_cli_modality_ckpts_overlays_stage1_tensors(tmp_path, monkeypatch):
    """Before the first step, the stage-2 encoder holds every stage-1
    tensor it declares, exactly (the other node types' link-prediction
    heads and the chemCPA decoder are left out), and its fresh init
    elsewhere."""
    from madrigal_tpu_torch.cli import modality_pretrain as t_s1_cli
    from madrigal_tpu_torch.models.encoder import init_weights

    s1 = ["--platform", "cpu", "--synthetic", "--synthetic_drugs", "16",
          "--synthetic_labels", "4", "--synthetic_edges", "16",
          "--num_epochs", "2", "--feature_dim", "16",
          "--save_dir", str(tmp_path / "s1")]
    paths = [t_s1_cli.main(s1 + ["--modality", m] + extra) for m, extra in (
        ("str", ["--gin_hidden_dims", "16", "16", "--gin_num_mlp_layer",
                 "2"]),
        ("kg", ["--hgt_hidden_dim", "8", "--hgt_att_heads", "2"]),
        ("cv", ["--cv_hidden_dims", "32", "16"]),
        ("tx", ["--tx_width", "32", "--tx_depth", "1"]))]
    starts, orig = [], t_pcl.CLPretrainer.__init__

    def snapshot(self, cfg, collator, kg, model, **kw):
        starts.append({k: v.clone() for k, v in model.state_dict().items()})
        orig(self, cfg, collator, kg, model, **kw)

    monkeypatch.setattr(t_pcl.CLPretrainer, "__init__", snapshot)
    res = t_pre_cli.main(CLI_ARGS + ["--num_steps", "1", "--save_dir",
                                     str(tmp_path / "cl"), "--modality_ckpts",
                                     *paths])
    start = starts[0]
    _, cfg = load_checkpoint(res["checkpoint"])
    ds = t_syn.make_dataset(num_drugs=16, num_labels=4, num_edges=16,
                            seed=42)
    fresh = init_weights(t_pcl.build_simclr_model(
        cfg, *kg_schema(ds.kg_node_feats, ds.kg_edge_indices)),
        torch.Generator().manual_seed(42)).state_dict()
    taken = set()
    for path in paths:
        sd, _ = load_checkpoint(path)
        for k, v in sd.items():
            name = "base_encoder." + k
            if name in start:
                assert torch.equal(start[name], v), name
                taken.add(name)
            else:
                assert k.startswith(("kg_encoder.lin__", "tx_encoder.decoder.")
                                    ) and "lin__drug" not in k, k
    assert {k.split(".")[1] for k in taken} == {
        "str_encoder", "kg_encoder", "cv_encoder", "tx_encoder"}
    assert any(k.endswith("running_var") for k in taken)
    for k, v in start.items():
        if k not in taken:
            assert torch.equal(v, fresh[k]), k


def test_train_ddi_warm_starts_from_the_ports_cl_last(tmp_path,
                                                      monkeypatch):
    """The stage-3 trainer receives the stage-2 run's encoder parameters
    (the uni projector too, under --use_pretrained_adaptor), exactly."""
    from madrigal_tpu_torch.train import finetune

    stage2 = t_pre_cli.main(CLI_ARGS + ["--num_steps", "2", "--save_dir",
                                        str(tmp_path / "cl")])
    sd, _ = load_checkpoint(stage2["checkpoint"])
    starts, orig = [], finetune.FinetuneTrainer.__init__

    def snapshot(self, cfg, batch, kg, model):
        starts.append({k: v.clone() for k, v in
                       model.named_parameters()})
        orig(self, cfg, batch, kg, model)

    monkeypatch.setattr(finetune.FinetuneTrainer, "__init__", snapshot)
    argv = ["--platform", "cpu", "--synthetic", "--synthetic_drugs", "16",
            "--synthetic_labels", "4", "--synthetic_edges", "16",
            "--num_epochs", "1", "--evaluate_interval", "0",
            "--checkpoint", stage2["checkpoint"],
            "--use_pretrained_adaptor", "--save_dir", str(tmp_path / "ft")]
    for flag, value in zip(CLI_ARGS, CLI_ARGS[1:]):
        if flag == "--set" and value.startswith("encoder."):
            argv += ["--set", "model." + value]
    t_cli.main(argv)
    got = starts[0]
    taken = 0
    for k, v in got.items():
        name = "base_encoder." + k[len("encoder."):]
        top = k.split(".")[1] if k.startswith("encoder.") else None
        if top is None or top in ("transformer", "pos_encoder", "cls",
                                  "tx_bottleneck_tokens"):
            continue
        assert torch.equal(v, sd[name]), k
        taken += 1
    assert taken > 20
