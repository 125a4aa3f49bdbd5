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
    keys of its forwards; --frozen trains the decoder only; the spans
    recording under torch.profiler leave a step's losses and weights as
    they are, bit for bit.

The training CLI, the mask sampler, the losses and early stopping are
held to the JAX package in tests/test_torch_train_cli.py, which shares
this module's CLI flags.
"""
import contextlib
import dataclasses

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
from madrigal_tpu_torch.train.optim import (
    param_labels,
    warmup_cosine_schedule,
)

LR = 3e-3
DATA = dict(num_drugs=16, num_labels=6, num_edges=30, seed=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models are tiny: torch's intra-op threads would only contend
    with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    # the fused k|v table's transposes (128 wide) run on K2 once a step
    # for each (layer, edge type) whose messages reach the drug table: in
    # the last layer the 2 edge types into drugs, in the first all 7 (into
    # drugs and into their source types); the other gathers' transposes
    # (the HGT's destinations, 64, and denominators, 4; the GIN's sources,
    # 16; chemCPA's embeddings, 16) run on it too
    assert calls.count(128) == 3 * (2 + 7)


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


# ------------------------------------------------------- shared CLI flags
# (tests/test_torch_train_cli.py and tests/test_torch_stage3.py run them)
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



# ---------------------------------------------------- more trainer cases
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


def test_spans_leave_the_step_bit_for_bit(data):
    """Two steps with the port's spans recording under torch.profiler
    give the losses and weights of two steps without, bit for bit."""
    from madrigal_tpu_torch.models.encoder import init_weights
    from madrigal_tpu_torch.utils import profiling

    dt, _, _, bt, kt = data
    runs = []
    for traced in (False, True):
        cfg = tiny_cfg(t_config, "str_random_sample")
        model = init_weights(MadrigalMultilabel(
            cfg.model.encoder, 6, *kg_schema(dt.kg_node_feats,
                                             dt.kg_edge_indices)),
            torch.Generator().manual_seed(0))
        tt = t_ft.FinetuneTrainer(cfg, bt, kt, model)
        tt.train_epoch()  # untraced in both runs
        with (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
              if traced else contextlib.nullcontext()):
            losses = [tt.train_epoch() for _ in range(2)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert [r.name for r in profiling.recorded()].count(
        "madrigal.optimizer") == 2
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


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
