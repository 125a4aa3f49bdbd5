"""The stage-1 CLI (`cli.modality_pretrain`) against the JAX CLI, and the
3-stage flow through the port's CLIs (the ports of
tests/test_cli_and_datasets.py::test_cli_modality_pretrain_all_four_then_cl
and tests/test_pipeline_3stage.py).

  * For each modality, both CLIs with the same flags on the same
    synthetic data: every host draw the trainer receives (str's labels
    and masks, kg's queries and labels, cv's rows, tx's minibatches)
    equal, exactly, and the checkpoints hold the same keys with the same
    shapes (the JAX tree through `interop/from_flax`), under
    `{modality}_encoder.`. The models start from different random
    weights (JAX's and torch's streams differ), so the losses are only
    finite.
  * The flow: the four stage-1 runs, then `cli.pretrain --modality_ckpts`
    with the four checkpoints, then `cli.train_ddi --checkpoint cl_last`,
    whose model starts from the stage-2 encoder.
"""
import numpy as np
import pytest
import torch

from madrigal_tpu.cli import modality_pretrain as j_cli
from madrigal_tpu.train import modality_pretrain as j_mp
from madrigal_tpu.train.checkpoint import load_checkpoint as j_load
from madrigal_tpu_torch.cli import modality_pretrain as t_cli
from madrigal_tpu_torch.cli import pretrain as t_pre_cli
from madrigal_tpu_torch.cli import train_ddi as t_ddi_cli
from madrigal_tpu_torch.interop.from_flax import flax_to_state_dict
from madrigal_tpu_torch.train import finetune
from madrigal_tpu_torch.train import modality_pretrain as t_mp
from madrigal_tpu_torch.train.checkpoint import load_checkpoint

COMMON = ["--synthetic", "--synthetic_drugs", "12", "--synthetic_labels",
          "4", "--synthetic_edges", "16", "--num_epochs", "3",
          "--platform", "cpu", "--feature_dim", "16"]
MODALITY_ARGS = {
    "str": ["--num_tasks", "5", "--gin_hidden_dims", "16", "16",
            "--gin_num_mlp_layer", "2"],
    "kg": ["--hgt_hidden_dim", "8", "--hgt_att_heads", "2"],
    "cv": ["--cv_hidden_dims", "32", "16"],
    "tx": ["--tx_width", "32", "--tx_depth", "1", "--tx_batch_size", "32",
           "--enable_adv"],
}
TRAINERS = {"str": "GINPretrainer", "kg": "HGTLinkPredTrainer",
            "cv": "TabularAETrainer", "tx": "ChemCPAAdaptTrainer"}
# the stage-2 and stage-3 encoder at the stage-1 runs' widths
ENCODER_SETS = ["feature_dim=16", "gin.hidden_dims=[16,16]",
                "gin.num_mlp_layer=2", "hgt.hidden_dim=8", "hgt.att_heads=2",
                "cv.hidden_dims=[32,16]", "chemcpa.dim=16",
                "chemcpa.autoencoder_width=32", "chemcpa.autoencoder_depth=1",
                "transformer.num_layers=1", "transformer.att_heads=2",
                "transformer.head_dim=8", "transformer.ffn_dim=32",
                "proj.hidden_dims=[32,32]"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models are tiny: torch's intra-op threads would only contend
    with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host_arrays(args) -> list:
    """The numpy arrays in a train_step's arguments (batches skipped)."""
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out += host_arrays(a)
        elif isinstance(a, torch.Tensor):
            out.append(a.cpu().numpy())
        elif isinstance(a, np.ndarray) or type(a).__module__.startswith(
                ("jax", "jaxlib")):
            out.append(np.asarray(a))
    return out


def recorded_run(monkeypatch, cli, module, modality, save_dir):
    """Run `cli` for `modality`; (its checkpoint path, the host arrays of
    every train_step call, the losses)."""
    cls = getattr(module, TRAINERS[modality])
    calls, losses, orig = [], [], cls.train_step

    def step(self, *args):
        calls.append(host_arrays(args))
        out = orig(self, *args)
        losses.append(out)
        return out

    monkeypatch.setattr(cls, "train_step", step)
    path = cli.main(COMMON + MODALITY_ARGS[modality]
                    + ["--modality", modality, "--save_dir", str(save_dir)])
    monkeypatch.setattr(cls, "train_step", orig)
    return path, calls, losses


@pytest.mark.parametrize("modality", list(MODALITY_ARGS))
def test_stage1_cli_matches_jax(modality, tmp_path, monkeypatch):
    jpath, jcalls, _ = recorded_run(monkeypatch, j_cli, j_mp, modality,
                                    tmp_path / "jax")
    tpath, tcalls, losses = recorded_run(monkeypatch, t_cli, t_mp, modality,
                                         tmp_path / "port")
    assert tpath.endswith(f"{modality}_pretrained")
    assert len(tcalls) == len(jcalls) == 3
    for a, b in zip(tcalls, jcalls):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    vals = [v for x in losses for v in (x.values() if isinstance(x, dict)
                                        else [x])]
    assert np.isfinite(vals).all()
    tree, meta = j_load(jpath)
    want = flax_to_state_dict({"params": tree["params"],
                               "batch_stats": tree.get("batch_stats") or {}})
    got, cfg = load_checkpoint(tpath)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(k.startswith(f"{modality}_encoder.") for k in got)
    assert type(cfg).__name__ == meta["config_class"]
    if modality == "tx":  # the whole chemCPA model, adversaries included
        assert any(".adversary_covariates." in k for k in got)
    if modality == "kg":  # every node type's head
        assert {k.split(".")[1] for k in got if ".lin__" in k} == {
            "lin__disease", "lin__drug", "lin__protein"}


@pytest.mark.parametrize("flag", [["--set", "hgt.remat_edge_types=true"],
                                  ["--from_yaml", "stage1.yaml"]])
def test_config_overrides_are_refused(flag, tmp_path):
    """Every stage-1 setting is a flag of the CLI (the JAX CLI parses
    --set and --from_yaml and ignores them)."""
    with pytest.raises(ValueError, match="flag of this CLI"):
        t_cli.main(COMMON + MODALITY_ARGS["kg"] + flag + [
            "--modality", "kg", "--save_dir", str(tmp_path)])
    assert not (tmp_path / "kg_pretrained").exists()


def test_three_stage_flow_through_the_cli(tmp_path, monkeypatch):
    s1 = tmp_path / "s1"
    paths = [t_cli.main(COMMON + MODALITY_ARGS[m]
                        + ["--modality", m, "--save_dir", str(s1)]
                        + (["--eval_disentanglement"] if m == "tx" else []))
             for m in MODALITY_ARGS]
    assert "tx_disent_covariate" in (s1 / "pretrain_tx_metrics.jsonl"
                                     ).read_text()
    argv = ["--synthetic", "--synthetic_drugs", "12", "--synthetic_labels",
            "4", "--synthetic_edges", "16", "--platform", "cpu"]
    sets = [a for s in ENCODER_SETS for a in ("--set", "encoder." + s)]
    stage2 = t_pre_cli.main(argv + sets + [
        "--num_steps", "3", "--batch_size", "8",
        "--save_dir", str(tmp_path / "s2"), "--modality_ckpts", *paths])
    assert np.isfinite(stage2["losses"]).all()
    cl_last, _ = load_checkpoint(stage2["checkpoint"])

    starts, orig = [], finetune.FinetuneTrainer.__init__

    def snapshot(self, cfg, batch, kg, model):
        starts.append({k: v.clone() for k, v in model.named_parameters()})
        orig(self, cfg, batch, kg, model)

    monkeypatch.setattr(finetune.FinetuneTrainer, "__init__", snapshot)
    res = t_ddi_cli.main(argv + [
        a for s in ENCODER_SETS for a in ("--set", "model.encoder." + s)] + [
        "--num_epochs", "1", "--evaluate_interval", "0",
        "--checkpoint", stage2["checkpoint"],
        "--save_dir", str(tmp_path / "s3")])
    assert np.isfinite([d["total"] for d in res["losses"]]).all()
    start = starts[0]
    for mod in ("str_encoder", "kg_encoder", "cv_encoder", "tx_encoder"):
        names = [k for k in start if k.startswith(f"encoder.{mod}.")]
        assert names
        for k in names:
            assert torch.equal(start[k], cl_last["base_encoder."
                                                 + k[len("encoder."):]]), k
