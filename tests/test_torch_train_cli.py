"""The port's training CLI and the smaller pieces of stage 3 against
the JAX package (the trainer itself: tests/test_torch_train.py).

  * The CLI trains on the CPU, and resuming after 2 epochs for 1 more
    gives the run of 3 straight. What it does not run raises before
    anything is written. With task=multiclass it trains the masked BCE
    and scores its sweeps with the multiclass metrics, as the JAX CLI
    does from the same weights: the same metric names, values within
    1e-4. With scripted val metrics it keeps the best model and stops
    early at the JAX CLI's epochs; the real sweep narrows by
    --eval_types and survives a resume.
  * The copies of the mask sampler, the losses and early stopping give
    the JAX package's results.
"""
import os

import jax
import numpy as np
import pytest
import torch

from madrigal_tpu.train import finetune as j_ft
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.cli import train_ddi as t_cli
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.interop.from_flax import load_flax_weights
from madrigal_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_train import CLI, DATA, one_thread  # noqa: F401


# ------------------------------------------------------------------ CLI
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

