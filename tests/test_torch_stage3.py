"""The rest of stage-3 training in the port against the JAX package: the
stage-2 warm start and the --data_dir and --all_train training CLIs.

  * Warm start, function level: from one JAX trainer's init carried into
    the port, JAX's `filter_cl_params_for_finetune` + `merge_params` with
    a JAX stage-2 tree, and the port's `warm_start_encoder` with its copy
    converted by `stage2_checkpoint_from_flax`, give equal parameters,
    exactly, with and without --use_pretrained_adaptor; the BatchNorm
    statistics stay at the init; and (with the adaptor) 3 trainer steps
    then agree within test_torch_train.py's tolerances.
  * Warm start, CLI level: the port's train_ddi --checkpoint keeps the
    checkpoint's encoder parameters (the uni projector only with the
    adaptor) and the run's own init for the dropped modules and every
    BatchNorm statistic.
  * The tables the port's --data_dir / --all_train CLI trains and
    evaluates on equal the JAX CLI's, row for row, the split-method quirk
    included (both train on split_by_triplets/train_df.csv whatever
    --split_method says), and the port's CLI trains 2 epochs on them.

The single-drug head and the extra tabular encoders are held to JAX in
test_torch_heads.py.
"""
import os

import numpy as np
import pytest
import torch

from madrigal_tpu.cli import train_ddi as j_cli
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import datasets as j_datasets
from madrigal_tpu.train import checkpoint as j_ckpt
from madrigal_tpu.train import finetune as j_ft
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.cli import train_ddi as t_cli
from madrigal_tpu_torch.data import datasets as t_datasets
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.interop.from_flax import (
    flax_to_state_dict,
    stage2_checkpoint_from_flax,
)
from madrigal_tpu_torch.train.checkpoint import (
    CL_TRANSFER_DROP_TOP,
    load_checkpoint,
    save_checkpoint,
    warm_start_encoder,
)
from test_torch_datasets import assert_tables_equal
from test_torch_models import _perturb
from test_torch_train import (
    CLI,
    assert_three_steps_match_jax,
    carried_trainers,
    data,  # noqa: F401  (the module-scoped fixture)
    one_thread,  # noqa: F401  (fixture)
)

BN_LEAVES = ("running_mean", "running_var", "num_batches_tracked")


def is_buffer(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in BN_LEAVES


def kept_tops(adaptor: bool) -> set:
    """The encoder's top-level modules a warm start does not take."""
    return set(CL_TRANSFER_DROP_TOP) | (set() if adaptor
                                        else {"uni_projector"})


# ------------------------------------------------------------ warm start
@pytest.mark.parametrize("adaptor", [True, False])
def test_warm_start_matches_jax(data, adaptor, tmp_path):  # noqa: F811
    jt, tt = carried_trainers(data, "str_random_sample", label_chunk=8)
    init = {k: v.clone() for k, v in tt.model.state_dict().items()}
    rng = np.random.RandomState(5)
    stage2 = {
        "params": {"base_encoder": _perturb(jt.state.params["encoder"], rng),
                   "predictor": {"dense_0": {"kernel": rng.randn(4, 3)}}},
        "batch_stats": {"base_encoder": _perturb(
            jt.state.batch_stats["encoder"], rng, "batch_stats")}}

    kept = j_ckpt.filter_cl_params_for_finetune(
        stage2["params"]["base_encoder"], use_pretrained_adaptor=adaptor)
    merged = j_ckpt.merge_params(jt.state.params["encoder"], kept)
    jt.state = j_ft.TrainState(
        params={**jt.state.params, "encoder": merged},
        batch_stats=jt.state.batch_stats, opt_state=jt.state.opt_state,
        epoch=jt.state.epoch)

    path = str(tmp_path / "stage2.pt")
    stage2_checkpoint_from_flax(stage2, path, t_config.PretrainConfig(),
                                epoch=3)
    sd, cfg = load_checkpoint(path)
    assert isinstance(cfg, t_config.PretrainConfig)
    assert any(k.startswith("base_encoder.transformer.") for k in sd)
    taken = warm_start_encoder(tt.model, sd, use_pretrained_adaptor=adaptor)
    assert {k.split(".")[0] for k in taken} == set(kept)
    assert ("uni_projector" in kept) == adaptor

    want = flax_to_state_dict({"params": jt.state.params})
    got = tt.model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in got.items():
        if is_buffer(k):
            assert torch.equal(v, init[k]), k  # the fresh statistics
        elif k.split(".")[1] in kept_tops(adaptor) or not k.startswith(
                "encoder."):
            assert torch.equal(v, init[k]), k  # dropped: the fresh init
        else:
            assert not torch.equal(v, init[k]), k  # taken
    if adaptor:
        assert_three_steps_match_jax(jt, tt)


def test_merge_params_refuses_mismatches():
    from madrigal_tpu_torch.train.checkpoint import merge_params

    init = {"a": torch.zeros(2, 3)}
    with pytest.raises(ValueError, match="shape mismatch"):
        merge_params(init, {"a": torch.zeros(3, 2)})
    with pytest.raises(KeyError):
        merge_params(init, {"b": torch.zeros(1)})


@pytest.mark.parametrize("adaptor", [True, False])
def test_cli_warm_start(tmp_path, adaptor):
    """--checkpoint with --num_epochs 0: the saved model is the warm start
    itself. The stage-2 checkpoint is the run's own init with every
    encoder entry moved (BatchNorm statistics too), plus a head the
    finetune model does not have."""
    cli = CLI + ["--num_epochs", "0", "--warmup_epochs", "0"]
    fresh = t_cli.main(cli + ["--save_dir", str(tmp_path / "fresh")])
    init, _ = load_checkpoint(fresh["checkpoint"])
    g = torch.Generator().manual_seed(9)
    stage2 = {"base_encoder." + k[len("encoder."):]:
              v + torch.rand(v.shape, generator=g) + 0.5
              if v.is_floating_point() else v + 3
              for k, v in init.items() if k.startswith("encoder.")}
    stage2["projector.dense_0.weight"] = torch.zeros(4, 4)
    path = str(tmp_path / "stage2.pt")
    save_checkpoint(path, stage2, t_config.PretrainConfig(), epoch=5)
    extra = ["--use_pretrained_adaptor"] if adaptor else []
    warm = t_cli.main(cli + ["--checkpoint", path, "--save_dir",
                             str(tmp_path / "warm")] + extra)
    got, _ = load_checkpoint(warm["checkpoint"])
    assert set(got) == set(init)
    for k, v in got.items():
        taken = (k.startswith("encoder.") and not is_buffer(k)
                 and k.split(".")[1] not in kept_tops(adaptor))
        want = stage2["base_encoder." + k[len("encoder."):]] if taken \
            else init[k]
        assert torch.equal(v, want), k
    assert any(k.startswith("encoder.uni_projector.") and torch.equal(
        got[k], stage2["base_encoder." + k[8:]]) for k in got) == adaptor


# ------------------------------------------------------- --data_dir CLIs
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A reference-format directory: the drugs and KG of a small
    synthetic dataset, split_by_triplets train/val/test tables and
    different split_by_pairs train/val/test tables."""
    root = str(tmp_path_factory.mktemp("reference"))
    ds, triplets = t_syn.make_split_dataset(num_drugs=14, num_labels=4,
                                            num_edges=24, seed=3)
    _, pairs = t_syn.make_split_dataset(
        num_drugs=14, num_labels=4, num_edges=24,
        split_method="split_by_pairs", seed=6)
    t_datasets.export_synthetic_as_reference_layout(ds, root)
    base = os.path.join(root, "polypharmacy_new", "TWOSIDES")
    for method, splits in (("split_by_triplets", triplets),
                           ("split_by_pairs", pairs)):
        for name, table in splits.items():
            t_datasets.write_edge_table(
                table, os.path.join(base, method, f"{name}_df.csv"))
    return root


class _Stop(Exception):
    pass


def jax_cli_tables(monkeypatch, argv):
    """(train table, {split: eval table}) of the JAX training CLI, read
    off its train collator and its split loads; it stops where it would
    build its trainer."""
    seen = {"evals": {}}
    init, load = j_collate.DDICollator.__init__, j_datasets.load_reference_dataset

    def collator(self, ds, split="train", *a, **kw):
        if split == "train":
            seen["train"] = ds.edge_df
        init(self, ds, split, *a, **kw)

    def load_split(root, *a, split="train", **kw):
        out = load(root, *a, split=split, **kw)
        if split != "train":
            seen["evals"][split] = out.edge_df
        return out

    def no_trainer(*a, **kw):
        raise _Stop

    monkeypatch.setattr(j_collate.DDICollator, "__init__", collator)
    monkeypatch.setattr(j_datasets, "load_reference_dataset", load_split)
    monkeypatch.setattr(j_ft, "FinetuneTrainer", no_trainer)
    with pytest.raises(_Stop):
        j_cli.main(argv)
    return seen["train"], seen["evals"]


@pytest.mark.parametrize("flags,evals", [
    ([], ["test", "val"]),
    (["--split_method", "split_by_pairs"], ["test", "val"]),
    (["--all_train"], [])])
def test_data_dir_cli_matches_jax_tables_and_trains(
        data_dir, monkeypatch, tmp_path, flags, evals):
    argv = [a for a in CLI if a != "--synthetic"] + [
        "--data_dir", data_dir, "--num_epochs", "2",
        "--save_dir", str(tmp_path)] + flags
    want_train, want_evals = jax_cli_tables(monkeypatch, argv)
    monkeypatch.undo()
    ds, coll, splits = t_cli._load_train_data(
        t_cli.build_parser().parse_args(argv), "cpu")
    assert coll.ds is ds and not coll.full_drug_table
    assert_tables_equal(ds.edge_df, want_train)
    assert sorted(splits) == sorted(want_evals) == evals
    for name in evals:
        assert_tables_equal(splits[name], want_evals[name])
    if flags[:1] == ["--split_method"]:  # the quirk: trains on triplets
        triplets = t_datasets.read_edge_table(os.path.join(
            data_dir, "polypharmacy_new", "TWOSIDES", "split_by_triplets",
            "train_df.csv"))
        assert_tables_equal(ds.edge_df, want_train)
        assert len(ds.edge_df) == len(triplets)
        assert (ds.edge_df["head"] == triplets["head"]).all()
    # 2 epochs; the plain --data_dir run also sweeps and tests
    sweep = [] if flags else ["--evaluate_interval", "1", "--test"]
    res = t_cli.main(argv + sweep)
    assert len(res["losses"]) == 2
    assert all(np.isfinite(v) for l in res["losses"] for v in l.values())
    assert len(res["eval_keys"]) == (1 if sweep else 0)
    assert np.isfinite(res["eval_keys"]).all()
    assert sorted(res["test_keys"]) == (["test"] if sweep else [])
