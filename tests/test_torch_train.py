"""The port's stage-3 training slice against the JAX package.

  * Train-mode BatchNorm under both variance rules against the JAX
    `MaskedBatchNorm` and flax `nn.BatchNorm`: outputs and updated running
    statistics (atol = rtol = 1e-5: the same f32 sums in another order;
    flax takes the variance as E[x^2] - E[x]^2).
  * The optimizer's parameter groups equal the JAX package's labels.
  * The label-chunked triple view and the chunked decoder equal JAX's.
  * `FinetuneTrainer`: 3 steps from the same weights (dropout 0) against
    the JAX trainer in each of its branches (one forward or three, the
    third with --train_with_str_str; the directed or the whole edge list;
    a padded mode among them):
    every step's losses (rtol 1e-4: whole-model sums in another order),
    step 1's gradients (the JAX ones read back from Adam's first moment;
    atol 1e-4 of each tensor's largest gradient, plus
    1e-6 of the model's: a bias ahead of a BatchNorm has a true gradient
    of 0 and carries rounding noise only), and each parameter's and
    BatchNorm statistic's change over the 3 steps (within 5e-2 of the
    norm of JAX's change; the schedule's learning rates are 0, lr / 2 and
    lr, so the third update is most of it, and the parameters after two
    steps are checked to fail by far). Left out are the tensors whose
    step-1 JAX gradient is rounding noise (nonzero, at most 1e-6 of the
    model's largest): Adam's 1/sqrt(v) turns that noise into an update of
    up to lr in either direction.
  * Every other finetune mode trains a step: finite losses, under the
    keys of its forwards.
  * The CLI trains on the CPU, and resuming after 2 epochs for 1 more
    gives the run of 3 straight. With task=multiclass it trains the
    masked BCE and scores its sweeps with the multiclass metrics, as the
    JAX CLI does from the same weights: the same metric names, values
    within 1e-4.
"""
import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.models import decoder as j_dec
from madrigal_tpu.models import norm as j_norm
from madrigal_tpu.train import finetune as j_ft
from madrigal_tpu.train.optim import param_labels as j_param_labels
from madrigal_tpu.train.optim import warmup_cosine_schedule as j_schedule
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.cli import train_ddi as t_cli
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.interop.from_flax import (
    flax_to_state_dict,
    load_flax_weights,
    torch_key,
)
from madrigal_tpu_torch.models import decoder as t_dec
from madrigal_tpu_torch.models import norm as t_norm
from madrigal_tpu_torch.models.encoder import MadrigalMultilabel
from madrigal_tpu_torch.ops import gather as t_gather
from madrigal_tpu_torch.ops.segment_sorted import sorted_segment_sum
from madrigal_tpu_torch.train import finetune as t_ft
from madrigal_tpu_torch.train.checkpoint import load_checkpoint
from madrigal_tpu_torch.train.optim import (
    param_labels,
    warmup_cosine_schedule,
)

LR = 3e-3
DATA = dict(num_drugs=16, num_labels=6, num_edges=30, seed=2)


def tiny_cfg(c, mode, label_chunk=0, train_with_str_str=False):
    """The flagship's structure at narrow widths, dropout 0; the HGT is 64
    wide, so its fused k|v table (128) takes kernel K2's backward."""
    enc = c.EncoderConfig(
        feature_dim=16,
        gin=c.GINConfig(hidden_dims=(16, 16), num_mlp_layer=2),
        hgt=c.HGTConfig(hidden_dim=64, num_layers=2, att_heads=4),
        cv=c.MLPEncoderConfig(hidden_dims=(32, 16), dropout=0.0, norm="bn"),
        chemcpa=c.ChemCPAConfig(dim=16, autoencoder_width=32,
                                autoencoder_depth=2),
        transformer=c.FusionConfig(num_layers=1, att_heads=2, head_dim=8,
                                   ffn_dim=32, dropout=0.0, norm_first=True,
                                   agg="x-attn", num_tx_bottlenecks=2),
        proj=c.ProjectorConfig(hidden_dims=(32, 32), dropout=0.0),
        pos_emb_type="sinusoidal", pos_emb_dropout=0.0,
    )
    lrs = dict(structure_encoder_lr=LR, kg_encoder_lr=LR,
               perturb_encoders_lr=LR, fusion_lr=LR, decoder_lr=LR)
    return c.TrainConfig(
        model=c.ModelConfig(encoder=enc, prediction_dim=6),
        optim=c.OptimizerConfig(**lrs), finetune_mode=mode, num_epochs=3,
        warmup_epochs=2, seed=0, label_chunk_triples=label_chunk,
        train_with_str_str=train_with_str_str)


# ------------------------------------------------------------ batch norm
@pytest.mark.parametrize("rule", ["masked", "flax"])
def test_batchnorm_train_mode_matches_jax(rule):
    rng = np.random.RandomState(1)
    x = (rng.randn(11, 6) * 2.0 + 0.5).astype(np.float32)
    mask = np.arange(11) < 8
    ra = {"mean": rng.randn(6).astype(np.float32),
          "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    if rule == "masked":
        jm, args = j_norm.MaskedBatchNorm(), (x, mask)
    else:
        jm = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5)
        args = (x,)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": ra}
    kw = {"train": True} if rule == "masked" else {}
    j_out, upd = jm.apply(v, *args, mutable=["batch_stats"], **kw)
    tm = t_norm.MaskedBatchNorm(6, flax_rule=rule == "flax")
    load_flax_weights(tm, v)
    t_out = tm.train()(torch.from_numpy(x), torch.from_numpy(mask))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               **tol)
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), **tol)


# ------------------------------------------------------ trainer fixtures
@pytest.fixture(scope="module")
def data():
    dj, dt = j_syn.make_dataset(**DATA), t_syn.make_dataset(**DATA)
    bj, kj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0,
                                   kg_src_sort=True)()
    bt, kt = t_collate.DDICollator(dt, split="train", device="cpu",
                                   kg_src_sort=True)()
    return dt, bj, kj, bt, kt


def carried_trainers(data, mode, label_chunk=0, train_with_str_str=False):
    """A JAX trainer and the port's, holding the JAX trainer's initial
    weights and batch statistics."""
    dt, bj, kj, bt, kt = data
    jt = j_ft.FinetuneTrainer(
        tiny_cfg(j_config, mode, label_chunk, train_with_str_str), bj, kj)
    cfg = tiny_cfg(t_config, mode, label_chunk, train_with_str_str)
    model = MadrigalMultilabel(cfg.model.encoder, 6,
                               *kg_schema(dt.kg_node_feats,
                                          dt.kg_edge_indices))
    load_flax_weights(model, {"params": jt.state.params,
                              "batch_stats": jt.state.batch_stats})
    return jt, t_ft.FinetuneTrainer(cfg, bt, kt, model)


def jax_first_step_grads(jt, beta1=0.9):
    """The gradients of the JAX trainer's first step, read back from
    Adam's first moment after it (mu = (1 - beta1) * g from a zero start;
    f32 rounding only): its fused step returns no gradients."""
    tree = {}
    for label, st in jt.state.opt_state.inner_states.items():
        if label == "frozen":
            continue
        for path, mu in jax.tree_util.tree_leaves_with_path(
                st.inner_state[0].mu):
            *parents, leaf = [k.key for k in path]
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = np.asarray(mu) / (1.0 - beta1)
    return flax_to_state_dict({"params": tree})


# the trainer branches on the mode's forwards (one, or three with
# --train_with_str_str) and its edge list (directed only, or both
# directions): each combination, a padded mode among them
THREE_STEP_MODES = [
    pytest.param("full_full", 0, False, id="full_full-0"),
    pytest.param("str_random_sample", 8, False, id="str_random_sample-8"),
    pytest.param("ablation_cv_cv_padded", 0, False,
                 id="ablation_cv_cv_padded-0"),
    pytest.param("str_str+random_sample", 8, True,
                 id="str_str+random_sample-8-train_with_str_str")]


@pytest.mark.parametrize("mode,label_chunk,with_str_str", THREE_STEP_MODES)
def test_trainer_three_steps_match_jax(data, mode, label_chunk, with_str_str,
                                       monkeypatch):
    calls = []

    def counted(*args):
        calls.append(args[0].shape[1])
        return sorted_segment_sum(*args)

    monkeypatch.setattr(t_gather, "sorted_segment_sum", counted)
    jt, tt = carried_trainers(data, mode, label_chunk, with_str_str)
    launches = sorted_segment_sum.launches
    assert_three_steps_match_jax(jt, tt)
    assert sorted_segment_sum.launches == launches  # CPU: plain version
    # K2 runs once a step for each (layer, edge type) whose messages reach
    # the drug table: in the last layer the 2 edge types into drugs, in
    # the first all 7 (into drugs and into their source types)
    assert calls == [128] * (3 * (2 + 7))


def assert_three_steps_match_jax(jt, tt):
    """3 steps of a JAX trainer and the port's from the same weights: the
    losses, step 1's gradients and each tensor's change over the 3 steps
    (the tolerances of the module docstring)."""
    before = flax_to_state_dict({"params": jt.state.params,
                                 "batch_stats": jt.state.batch_stats})
    for step in range(3):
        lj, lt = jt.train_epoch(), tt.train_epoch()
        assert set(lj) == set(lt)
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=1e-4,
                                       err_msg=f"step {step} {k}")
        if step == 0:
            j_grads = jax_first_step_grads(jt)
            top = max(float(g.abs().max()) for g in j_grads.values())
            for name, p in tt.model.named_parameters():
                ref = j_grads[name].numpy()
                np.testing.assert_allclose(
                    p.grad.numpy(), ref, rtol=0,
                    atol=1e-4 * np.abs(ref).max() + 1e-6 * top,
                    err_msg=name)
        if step == 1:
            after_two = {k: v.clone() for k, v in
                         tt.model.state_dict().items()}
    want = flax_to_state_dict({"params": jt.state.params,
                               "batch_stats": jt.state.batch_stats})
    noise = {name for name, g in j_grads.items()
             if 0 < float(g.abs().max()) <= 1e-6 * top}

    def change_errors(got):
        """|port's change - JAX's change| / |JAX's change| per tensor
        (the absolute difference where JAX's change is 0)."""
        errs = {}
        for name, ref in want.items():
            if name in noise:
                continue
            dj = (ref - before[name]).double()
            dt = (got[name] - before[name]).double()
            errs[name] = float((dt - dj).norm() / (dj.norm() or 1.0))
        return errs

    assert set(want) <= set(tt.model.state_dict())
    errs = change_errors(tt.model.state_dict())
    assert len(errs) > len(want) // 2
    bad = {k: e for k, e in errs.items() if e > 5e-2}
    assert not bad, bad
    # the check sees the last optimizer update: the parameters after two
    # steps of three fail it by far
    moved = {k for k in errs if k in j_grads
             and float((want[k] - before[k]).norm()) > 0}
    short = change_errors(after_two)
    assert moved and min(short[k] for k in moved) > 0.5


@pytest.mark.parametrize("fusion_policy,hgt_remat", [
    ("none", False), ("dots", False), ("all", False), (None, True)])
def test_remat_keeps_losses_and_gradients(data, fusion_policy, hgt_remat):
    """Rematerializing the fusion transformer (under each policy; None:
    not at all) or the HGT's edge types gives the step's losses and gradients of the run
    that keeps every activation (rtol 1e-6, atol 1e-6 of each tensor's
    largest: the recompute repeats the same f32 ops, with dropout on and
    its masks replayed), and keeps fewer bytes for the backward."""
    from madrigal_tpu_torch.models.encoder import init_weights

    dt, _, _, bt, kt = data

    def step(remat):
        cfg = tiny_cfg(t_config, "str_random_sample", label_chunk=8)
        enc = cfg.model.encoder
        if remat:
            enc = dataclasses.replace(
                enc,
                transformer=dataclasses.replace(
                    enc.transformer, remat=fusion_policy is not None,
                    remat_policy=(None if fusion_policy == "none"
                                  else fusion_policy)),
                hgt=dataclasses.replace(enc.hgt, remat_edge_types=hgt_remat))
        enc = dataclasses.replace(enc, transformer=dataclasses.replace(
            enc.transformer, dropout=0.2))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, encoder=enc))
        model = init_weights(MadrigalMultilabel(
            enc, 6, *kg_schema(dt.kg_node_feats, dt.kg_edge_indices)),
            torch.Generator().manual_seed(0))
        tt = t_ft.FinetuneTrainer(cfg, bt, kt, model)
        kept = []

        def pack(t):
            kept.append(t.numel() * t.element_size())
            return t

        torch.manual_seed(0)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            losses = tt.train_epoch()
        return losses, dict(model.named_parameters()), sum(kept)

    (l0, p0, kept0), (l1, p1, kept1) = step(False), step(True)
    assert l1 == pytest.approx(l0, rel=1e-6)
    for name, p in p0.items():
        ref = p.grad.numpy()
        np.testing.assert_allclose(p1[name].grad.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)
    assert kept1 < kept0


def test_param_labels_match_jax(data):
    jt, tt = carried_trainers(data, "full_full")
    flat = jax.tree_util.tree_leaves_with_path(j_param_labels(
        jt.state.params))
    want = {torch_key([k.key for k in path]): lab for path, lab in flat}
    assert param_labels(tt.model) == want
    groups = {g["label"]: len(g["params"])
              for g in tt.optimizer.param_groups}
    assert sum(groups.values()) == len(want)
    assert {"str", "str_nd", "kg", "kg_nd", "perturb", "perturb_nd",
            "fusion", "fusion_nd", "decoder"} == set(groups)


def test_warmup_cosine_schedule_matches_jax():
    for step in range(12):
        np.testing.assert_allclose(warmup_cosine_schedule(0.5, 3, 11)(step),
                                   float(j_schedule(0.5, 3, 11)(step)),
                                   rtol=1e-5, atol=1e-9)  # JAX's is f32


def test_label_chunk_view_and_chunked_triples_match_jax(data):
    _, bj, _, bt, _ = data
    vj, clj = j_ft.label_chunk_view(bj, 4, align=16)
    vt, clt = t_ft.label_chunk_view(bt, 4, align=16)
    np.testing.assert_array_equal(clt.numpy(), np.asarray(clj))
    for name in ("head_idx", "tail_idx", "labels", "pos_neg", "mask"):
        np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                      np.asarray(getattr(vj, name)), name)
    rng = np.random.RandomState(3)
    T, D = vt.labels.shape[0], 8
    zh = rng.randn(T, D).astype(np.float32)
    zt = rng.randn(T, D).astype(np.float32)
    jm = j_dec.BilinearDDIScorer(num_labels=6, input_dim1=D, input_dim2=D)
    v = jm.init(jax.random.PRNGKey(1), zh[:2], zt[:2])
    want = jm.apply(v, zh, zt, np.asarray(vj.labels), chunk_labels=clj,
                    label_chunk=4, method=j_dec.BilinearDDIScorer.triples)
    tm = load_flax_weights(t_dec.BilinearDDIScorer(6, D, D), v)
    tm.SCAN_WEIGHT_ROWS = 3  # several bounded steps
    with torch.no_grad():
        got = tm.triples(torch.from_numpy(zh), torch.from_numpy(zt),
                         vt.labels, chunk_labels=clt, label_chunk=4)
        plain = tm.triples(torch.from_numpy(zh), torch.from_numpy(zt),
                           vt.labels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------------ CLI
CLI = ["--platform", "cpu", "--synthetic", "--synthetic_drugs", "14",
       "--synthetic_labels", "4", "--synthetic_edges", "20", "--seed", "3",
       "--evaluate_interval", "0", "--label_chunk", "8",
       "--set", "model.encoder.transformer.dropout=0.0",
       "--set", "model.encoder.proj.dropout=0.0",
       "--set", "model.encoder.cv.dropout=0.0",
       "--set", "model.encoder.pos_emb_dropout=0.0",
       "--set", "model.encoder.hgt.hidden_dim=64",
       "--set", "model.encoder.transformer.num_layers=1",
       "--set", "warmup_epochs=1"]


def test_cli_trains_and_resumes(tmp_path):
    """3 epochs straight, and 2 epochs then --resume for the third, give
    the same losses (rtol 1e-5) and weights (atol 6 * lr, lr = 1e-4: the
    CPU's threaded sums are not bitwise repeatable, and Adam turns that
    noise on a near-zero gradient into an update of up to lr per step on
    each side, in either direction).
    warmup 0 keeps the learning rate of the 2-epoch run's schedule equal
    to the 3-epoch run's."""
    cli = CLI + ["--warmup_epochs", "0"]
    straight = t_cli.main(cli + ["--num_epochs", "3",
                                 "--save_dir", str(tmp_path / "a")])
    assert len(straight["losses"]) == 3
    assert all(np.isfinite(l["total"]) for l in straight["losses"])
    assert {"X_X", "str_X", "total"} == set(straight["losses"][0])
    first = t_cli.main(cli + ["--num_epochs", "2",
                              "--save_dir", str(tmp_path / "b")])
    resumed = t_cli.main(cli + ["--num_epochs", "3", "--resume",
                                first["checkpoint"],
                                "--save_dir", str(tmp_path / "c")])
    assert len(resumed["losses"]) == 1
    np.testing.assert_allclose(
        [l["total"] for l in first["losses"] + resumed["losses"]],
        [l["total"] for l in straight["losses"]], rtol=1e-5)
    sd_a, cfg = load_checkpoint(straight["checkpoint"])
    sd_c, _ = load_checkpoint(resumed["checkpoint"])
    assert cfg.num_epochs == 3 and cfg.label_chunk_triples == 8
    for k in sd_a:
        np.testing.assert_allclose(sd_c[k].numpy(), sd_a[k].numpy(),
                                   atol=6e-4, rtol=0, err_msg=k)
    assert os.path.exists(tmp_path / "a" / "train_ddi_metrics.jsonl")


@pytest.mark.parametrize("extra", [
    ["--set", "model.encoder.hgt.shard_axis=kg"],
    ["--set", "model.encoder.str_encoder=gcn"],
    ["--set", "model.encoder.kg_encoder=gnn"], ["--set", "loss_fn_name=ce"],
    ["--platform", "tpu"],
    ["--all_train", "--set", "model.encoder.hgt.shard_axis=kg"]])
def test_unported_training_flags_raise(tmp_path, extra):
    """What the port does not run (the graph-parallel HGT of the multi-GPU
    port, ROADMAP; encoders that neither package builds; the cross-entropy
    loss; the JAX package's platform) raises before anything is written.
    The GAT, HAN and RGCN encoders train: tests/test_torch_alt_encoders.py."""
    argv = CLI + ["--num_epochs", "3", "--save_dir", str(tmp_path)] + extra
    with pytest.raises(NotImplementedError):
        t_cli.main(argv)
    assert not os.path.exists(tmp_path / "last_model")


@pytest.mark.parametrize("mode", [
    m for m in t_config.FINETUNE_MODES
    if m not in {p.values[0] for p in THREE_STEP_MODES}])
def test_every_other_mode_trains_a_step(data, mode):
    from madrigal_tpu_torch.models.encoder import init_weights

    dt, _, _, bt, kt = data
    cfg = tiny_cfg(t_config, mode)
    model = init_weights(MadrigalMultilabel(
        cfg.model.encoder, 6, *kg_schema(dt.kg_node_feats,
                                         dt.kg_edge_indices)),
        torch.Generator().manual_seed(0))
    tt = t_ft.FinetuneTrainer(cfg, bt, kt, model)
    losses = tt.train_epoch()
    assert set(losses) == ({"X_X", "str_X", "total"}
                           if tt.masker.uses_three_way_loss else {"total"})
    assert all(np.isfinite(v) for v in losses.values()), losses


def test_cli_multiclass_matches_jax(tmp_path, monkeypatch):
    """task=multiclass (DrugBank): both CLIs from the JAX CLI's initial
    weights for 2 epochs, sweeping the val split after the second."""
    from madrigal_tpu.cli import train_ddi as j_cli
    from madrigal_tpu.eval import evaluate as j_evaluate
    from madrigal_tpu_torch.eval import evaluate as t_evaluate
    from madrigal_tpu_torch.models import encoder as t_encoder

    init, orig_init = [], j_ft.FinetuneTrainer.__init__

    def capture(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        # copied: the JAX step donates its state's buffers
        init.append(jax.tree_util.tree_map(np.array, {
            "params": self.state.params,
            "batch_stats": self.state.batch_stats}))

    monkeypatch.setattr(j_ft.FinetuneTrainer, "__init__", capture)
    monkeypatch.setattr(t_encoder, "init_weights",
                        lambda model, gen: load_flax_weights(model, init[0]))
    sweeps = {"jax": [], "port": []}

    def spy(pkg, real):
        def evaluate_ft(self, *args, **kwargs):
            key = real(self, *args, **kwargs)
            assert self.task == "multiclass"
            sweeps[pkg].append((key, dict(self.best_metrics)))
            return key
        return evaluate_ft

    monkeypatch.setattr(j_evaluate.Evaluator, "evaluate_ft", spy(
        "jax", j_evaluate.Evaluator.evaluate_ft))
    monkeypatch.setattr(t_evaluate.Evaluator, "evaluate_ft", spy(
        "port", t_evaluate.Evaluator.evaluate_ft))
    argv = [a for a in CLI] + ["--set", "data_source=DrugBank",
                               "--set", "task=multiclass",
                               "--eval_types", "full_full,str_str",
                               "--num_epochs", "2"]
    argv[argv.index("--evaluate_interval") + 1] = "1"
    j_cli.main(argv + ["--save_dir", str(tmp_path / "jax")])
    res = t_cli.main(argv + ["--save_dir", str(tmp_path / "port")])
    assert load_checkpoint(res["checkpoint"])[1].task == "multiclass"
    assert len(sweeps["port"]) == len(sweeps["jax"]) == 1
    for (kt_, mt), (kj_, mj) in zip(sweeps["port"], sweeps["jax"]):
        assert np.isfinite(kj_) and abs(kt_ - kj_) <= 1e-4
        assert sorted(mt) == sorted(mj)
        for k, want in mj.items():
            got = mt[k]
            assert (np.isnan(got) and np.isnan(want)) or abs(
                got - want) <= 1e-4, (k, got, want)


def scripted_sweeps(monkeypatch, keys):
    """Both packages' Evaluator.evaluate_ft return `keys` in turn for val
    splits and 0.123 for test splits; returns the list of splits asked
    for, per package."""
    from madrigal_tpu.eval import evaluate as j_evaluate
    from madrigal_tpu_torch.eval import evaluate as t_evaluate

    calls = {"jax": [], "port": []}
    seqs = {"jax": iter(keys), "port": iter(keys)}

    def fake(pkg):
        def evaluate_ft(self, *args, eval_types=None):
            split = args[-1]
            calls[pkg].append(split)
            return 0.123 if split.startswith("test") else next(seqs[pkg])
        return evaluate_ft

    monkeypatch.setattr(j_evaluate.Evaluator, "evaluate_ft", fake("jax"))
    monkeypatch.setattr(t_evaluate.Evaluator, "evaluate_ft", fake("port"))
    return calls


def test_cli_early_stopping_matches_jax(tmp_path, monkeypatch):
    """The same sequence of val key metrics in both CLIs: best_model and
    last_model at the same epochs, the same sweeps, and early stopping at
    the same epoch (keys 0.5, 0.6, 0.55, 0.58 at epochs 1-4 with patience
    1: best at 2, stop at 4)."""
    from madrigal_tpu.cli import train_ddi as j_cli
    from madrigal_tpu.train.checkpoint import load_checkpoint as j_load
    from madrigal_tpu_torch.train.checkpoint import load_train_state

    calls = scripted_sweeps(monkeypatch, [0.5, 0.6, 0.55, 0.58, 0.7, 0.8])
    argv = [a for a in CLI] + ["--finetune_mode", "full_full",
                               "--num_epochs", "7", "--patience", "1",
                               "--test"]
    argv[argv.index("--evaluate_interval") + 1] = "1"
    j_cli.main(argv + ["--save_dir", str(tmp_path / "jax")])
    res = t_cli.main(argv + ["--save_dir", str(tmp_path / "port")])
    assert calls["port"] == calls["jax"] == ["val"] * 4 + ["test"]
    assert res["stopped_epoch"] == 4 and res["best_epoch"] == 2
    assert res["eval_keys"] == [0.5, 0.6, 0.55, 0.58]
    assert res["test_keys"] == {"test": 0.123}
    for name in ("best_model", "last_model"):
        want = j_load(str(tmp_path / "jax" / name))[1]["epoch"]
        got = load_train_state(str(tmp_path / "port" / name))[0]
        assert got == want, name
    assert load_train_state(str(tmp_path / "port" / "best_model"))[2][
        "best_key"] == 0.6


def test_cli_evaluation_sweep_and_resume(tmp_path, monkeypatch):
    """The real sweep: --eval_types narrows it, best_model and the test
    sweep are written and loadable, and a resume keeps the best-model
    tracking of the run it resumes."""
    from madrigal_tpu_torch.eval import evaluate as t_evaluate
    from madrigal_tpu_torch.eval.predict import model_from_checkpoint

    seen = []
    real = t_evaluate.Evaluator.evaluate_ddi

    def spy(self, batch, kg, eval_type, split):
        seen.append((split, eval_type))
        return real(self, batch, kg, eval_type, split)

    monkeypatch.setattr(t_evaluate.Evaluator, "evaluate_ddi", spy)
    argv = [a for a in CLI] + ["--eval_types", "full_full,str_str",
                               "--test"]
    argv[argv.index("--evaluate_interval") + 1] = "1"
    first = t_cli.main(argv + ["--num_epochs", "3",
                               "--save_dir", str(tmp_path / "a")])
    assert len(first["eval_keys"]) == 2  # after epochs 1 and 2
    assert all(np.isfinite(first["eval_keys"]))
    assert first["best_key"] == max(first["eval_keys"])
    assert set(seen) == {(sp, et) for sp in ("val", "test")
                         for et in ("full_full", "str_str")}
    assert np.isfinite(first["test_keys"]["test"])
    model, _ = model_from_checkpoint(str(tmp_path / "a" / "best_model"),
                                     device="cpu")
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())
    with open(tmp_path / "a" / "train_ddi_metrics.jsonl") as f:
        assert "val_key_auprc" in f.read()
    resumed = t_cli.main(argv + ["--num_epochs", "4", "--resume",
                                 first["checkpoint"],
                                 "--save_dir", str(tmp_path / "a")])
    assert resumed["best_key"] >= first["best_key"]
    assert (resumed["best_epoch"] == first["best_epoch"]) == (
        resumed["eval_keys"][0] <= first["best_key"])


# ------------------------------------------- copies and smaller pieces
@pytest.mark.parametrize("mode", t_config.FINETUNE_MODES)
def test_masker_copy_matches_jax(mode):
    """The port's copy of the mask sampler gives the JAX package's masks,
    epoch after epoch, for every finetune mode."""
    from madrigal_tpu.train.masking import FinetuneMasker as JMasker
    from madrigal_tpu_torch.train.masking import FinetuneMasker as TMasker

    base = t_syn.make_dataset(**DATA).masks
    non_tx = ["str", "kg", "cv"]
    jm, tm = JMasker(mode, base, non_tx, seed=3), TMasker(mode, base,
                                                         non_tx, seed=3)
    assert (jm.uses_three_way_loss, jm.edges_directed_only()) == (
        tm.uses_three_way_loss, tm.edges_directed_only())
    for _ in range(3):
        for a, b in zip(jm.sample_epoch(), tm.sample_epoch()):
            np.testing.assert_array_equal(a, b)


def test_losses_match_jax():
    """masked_bce, info_nce and ce_loss_for_pairs against the JAX losses
    (rtol 1e-5: the same f32 math)."""
    from madrigal_tpu.train import losses as jl
    from madrigal_tpu_torch.train import losses as tl

    rng = np.random.RandomState(7)
    logits = (3 * rng.randn(40)).astype(np.float32)
    targets = (rng.rand(40) < 0.4).astype(np.int32)
    w = (rng.rand(40) < 0.7).astype(np.float32)
    for readout in ("mean", "sum"):
        np.testing.assert_allclose(
            tl.masked_bce(*map(torch.from_numpy, (logits, targets, w)),
                          readout).item(),
            float(jl.masked_bce(logits, targets, w, readout)), rtol=1e-5)
    a, b = rng.randn(6, 8).astype(np.float32), rng.randn(6, 8).astype(
        np.float32)
    hard = rng.rand(6, 6) < 0.2
    np.fill_diagonal(hard, False)
    for mask in (None, hard):
        got = tl.info_nce(torch.from_numpy(a), torch.from_numpy(b), 0.1,
                          None if mask is None else torch.from_numpy(mask))
        want = jl.info_nce(a, b, 0.1, mask)
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5)
    pl = rng.randn(40, 5).astype(np.float32)
    lab = rng.randint(0, 5, 40).astype(np.int32)
    np.testing.assert_allclose(
        tl.ce_loss_for_pairs(*map(torch.from_numpy, (pl, lab, w))).item(),
        float(jl.ce_loss_for_pairs(pl, lab, w)), rtol=1e-5)


def test_early_stopping_and_finite_check_match_jax():
    from madrigal_tpu.train import checkpoint as jc
    from madrigal_tpu_torch.train import checkpoint as tc

    scores = [0.1, 0.3, 0.2, 0.25, None, 0.29, 0.31, 0.1, 0.1, 0.1]
    js, ts = jc.EarlyStopping(2), tc.EarlyStopping(2)
    assert [js(x) for x in scores] == [ts(x) for x in scores]
    assert tc.check_finite_loss({"a": 1.0}) == {"a": 1.0}
    with pytest.raises(FloatingPointError, match="'b'"):
        tc.check_finite_loss({"a": 1.0, "b": float("nan")})
    with pytest.raises(FloatingPointError):
        tc.check_finite_loss(float("inf"))


def test_frozen_trains_the_decoder_only(data):
    """cfg.frozen (--frozen) leaves every encoder weight as it was and
    trains the decoder (the JAX package's set_to_zero groups)."""
    from madrigal_tpu_torch.models.encoder import init_weights

    dt, _, _, bt, kt = data
    cfg = dataclasses.replace(tiny_cfg(t_config, "full_full"), frozen=True)
    model = init_weights(MadrigalMultilabel(
        cfg.model.encoder, 6, *kg_schema(dt.kg_node_feats,
                                         dt.kg_edge_indices)),
        torch.Generator().manual_seed(0))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tt = t_ft.FinetuneTrainer(cfg, bt, kt, model)
    assert {g["label"] for g in tt.optimizer.param_groups} == {"decoder"}
    for _ in range(3):  # step 0 is inside warmup (lr 0)
        tt.train_epoch()
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]) != k.startswith("decoder."), k
