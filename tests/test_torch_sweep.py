"""The chemCPA sweep in the port against the JAX package.

  * `generate_configs`, `unflatten` and `merge_dicts` equal the JAX ones
    on grid, fixed and random blocks; one `.json` sweep file read by the
    JAX `read_config` (pyyaml) and by the port's (json) gives the same
    configs, and so does one `.yaml` file through both.
  * `sweep_config_to_trainer_args` gives equal ChemCPAConfig fields and
    trainer and loop kwargs.
  * `train_one_config` with both trainers started from the same weights
    (the JAX trainer's initial variables through
    `interop/from_flax.chemcpa_adapt_state_dict`), dropout 0: the same
    evaluations, epochs and stop reason; losses and R2 within 1e-4
    relative. The rate is 1e-4: Adam turns the rounding-noise gradient of
    a bias ahead of a BatchNorm into a step of up to lr either way, which
    the train-mode losses cancel (they agree to 1e-6) and the eval-mode R2
    does not (at lr 1e-3 it moves R2 by 3e-4 relative, at 1e-4 by 2e-5,
    while R2 itself moves by 0.05 over the run).
  * The NaN stops and the early stop (R2 scripted in both packages) give
    the JAX function's stop_reason, epochs_run and history.
  * Both CLIs on `--synthetic` with one JSON file: the same configs, the
    same train and test rows, the same JSONL keys; the port's best
    checkpoint overlays onto an encoder through
    `overlay_stage1_checkpoint`.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.cli import chemcpa_sweep as j_cli
from madrigal_tpu.train import chemcpa_sweep as j_sweep
from madrigal_tpu.train import modality_pretrain as j_mp
from madrigal_tpu.utils import config_gen as j_gen
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.cli import chemcpa_sweep as t_cli
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.data.synthetic import make_dataset
from madrigal_tpu_torch.interop import from_flax
from madrigal_tpu_torch.models.encoder import MadrigalEncoder
from madrigal_tpu_torch.train import chemcpa_sweep as t_sweep
from madrigal_tpu_torch.train import modality_pretrain as t_mp
from madrigal_tpu_torch.train.checkpoint import load_checkpoint
from madrigal_tpu_torch.train.transfer import overlay_stage1_checkpoint
from madrigal_tpu_torch.utils import config_gen as t_gen

# floats with a dot and a signed exponent: pyyaml (YAML 1.1) reads
# "1e-05" as a string
SWEEP = {
    "seml": {"executable": "sweep.py", "output_dir": "logs"},
    "slurm": {"sbatch_options": {"mem": "8G"}},
    "fixed": {"training.num_epochs": 3, "training.checkpoint_freq": 1,
              "model.hparams.dim": 8, "model.hparams.batch_size": 512,
              "model.hparams.dropout": 0.0,
              "model.additional_params.patience": 2},
    "grid": {"model.hparams.autoencoder_width": {
        "type": "choice", "options": [16, 24]}},
    "random": {"samples": 1, "seed": 3,
               "model.hparams.autoencoder_lr": {
                   "type": "loguniform", "min": 1.0e-4, "max": 1.0e-2}},
}
SWEEP_YAML = """
fixed:
  training.num_epochs: 3
  model.hparams.dim: 8
  model.hparams.autoencoder_lr: 1.0e-3
  model.use_drugs: false
grid:
  model.hparams.autoencoder_depth:
    type: range
    min: 1
    max: 3
    step: 1
random:
  samples: 3
  model.hparams.dropout:
    type: uniform
    min: 0.1
    max: 0.5
  model.hparams.adversary_lr:
    type: loguniform
    min: 1.0e-5
    max: 1.0e-3
  model.hparams.autoencoder_width:
    type: choice
    options: [16, 32]
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_sweep_json(path):
    """SWEEP as JSON, its floats written as 1.0e-04 (module comment)."""
    path.write_text(json.dumps(SWEEP).replace("0.0001", "1.0e-04").replace(
        "0.01", "1.0e-02"))


# ------------------------------------------------------------ config_gen
@pytest.mark.parametrize("block", ["fixed", "grid", "random", "all"])
def test_generate_configs_match_jax(block):
    exp = {k: v for k, v in SWEEP.items() if k in ("fixed", "grid",
                                                   "random")}
    if block != "all":
        exp = {block: exp[block]}
    for seed in (0, 5):
        want = j_gen.generate_configs(exp, seed=seed)
        assert t_gen.generate_configs(exp, seed=seed) == want
    flat = {"a.b.c": 1, "a.d": 2, "e": 3}
    assert t_gen.unflatten(flat) == j_gen.unflatten(flat)
    a, b = {"x": {"y": 1, "z": 2}, "w": 0}, {"x": {"y": 5}, "v": {"q": 1}}
    assert t_gen.merge_dicts(a, b) == j_gen.merge_dicts(a, b)


def test_read_config_json_and_yaml_match_jax(tmp_path):
    js = tmp_path / "sweep.json"
    write_sweep_json(js)
    ym = tmp_path / "sweep.yaml"
    ym.write_text(SWEEP_YAML)
    for path in (js, ym):
        want = j_gen.read_config(str(path))
        got = t_gen.read_config(str(path))
        assert got == want
        assert (t_gen.generate_configs(got[2], seed=1)
                == j_gen.generate_configs(want[2], seed=1))
    assert t_gen.read_config(str(js))[0] == SWEEP["seml"]


def test_sweep_config_to_trainer_args_match_jax(tmp_path):
    ym = tmp_path / "sweep.yaml"
    ym.write_text(SWEEP_YAML + """
  model.additional_params.decoder_activation:
    type: choice
    options: [ReLU, linear]
""")
    configs = t_gen.generate_configs(t_gen.read_config(str(ym))[2], seed=2)
    assert len(configs) == 6
    for args in configs:
        jc, jt, jr = j_sweep.sweep_config_to_trainer_args(
            args, j_config.ChemCPAConfig(num_genes=30, num_covariates=4))
        tc, tt, tr = t_sweep.sweep_config_to_trainer_args(
            args, t_config.ChemCPAConfig(num_genes=30, num_covariates=4))
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tt, tr) == (jt, jr)


# --------------------------------------------------------- train_one_config
CFG = dict(num_genes=12, dim=8, autoencoder_width=16, autoencoder_depth=1,
           num_covariates=2, use_drugs=False, dropout=0.0)
# every batch has this many rows (48 training rows), so that the JAX
# package compiles one shape
BATCH = 24


def rows(seed=0, n=64):
    rng = np.random.RandomState(seed)
    genes = (np.abs(rng.randn(n, 12)) + 0.5).astype(np.float32)
    return genes, rng.randint(0, 2, n).astype(np.int32)


@pytest.fixture
def same_init(monkeypatch):
    """The port's trainers start from the JAX trainer's initial weights
    (its init depends only on the seed and the shapes)."""
    def factory(cfg, device=None, **kw):
        jt = j_mp.ChemCPAAdaptTrainer(j_config.ChemCPAConfig(**CFG), **kw)
        genes, cov = rows()
        jt._init(genes[:BATCH], cov[:BATCH], None, None)
        tt = t_mp.ChemCPAAdaptTrainer(cfg, device=device, **kw)
        tt.model.load_state_dict(from_flax.chemcpa_adapt_state_dict(
            jax.tree_util.tree_map(np.asarray, jt._vars)))
        return tt

    monkeypatch.setattr(t_sweep, "ChemCPAAdaptTrainer", factory)


def run_both(tkw, rkw, genes, cov, test_genes, test_cov):
    jr = j_sweep.train_one_config(j_config.ChemCPAConfig(**CFG), tkw, rkw,
                                  genes, cov, test_genes, test_cov)
    tr = t_sweep.train_one_config(t_config.ChemCPAConfig(**CFG), tkw, rkw,
                                  genes, cov, test_genes, test_cov,
                                  device="cpu")
    return jr, tr


def assert_same_history(jr, tr, rtol=1e-4):
    assert (tr["epochs_run"], tr["stop_reason"]) == (jr["epochs_run"],
                                                     jr["stop_reason"])
    assert [h["epoch"] for h in tr["history"]] == [
        h["epoch"] for h in jr["history"]]
    for key in ("loss_reconstruction", "test_r2"):
        np.testing.assert_allclose([h[key] for h in tr["history"]],
                                   [h[key] for h in jr["history"]],
                                   rtol=rtol)


def test_train_one_config_matches_jax(same_init):
    genes, cov = rows()
    rkw = {"num_epochs": 4, "checkpoint_freq": 1, "max_minutes": 10,
           "batch_size": BATCH, "patience": 5}
    jr, tr = run_both({"lr": 1e-4, "seed": 0}, rkw, genes[16:], cov[16:],
                      genes[:16], cov[:16])
    assert_same_history(jr, tr)
    assert len(tr["history"]) == 3  # epochs 1, 2, 3 (the last)
    np.testing.assert_allclose(tr["best_r2"], jr["best_r2"], rtol=1e-4)
    best = tr["best_variables"]
    assert all(v.device.type == "cpu" for v in best.values())
    assert best.keys() == tr["trainer"].model.state_dict().keys()


@pytest.mark.parametrize("case", ["nan_loss", "nan_r2", "early_stop"])
def test_stop_rules_match_jax(case, same_init, monkeypatch):
    genes, cov = rows()
    test_genes, test_cov = genes[:16], cov[:16]
    genes, cov = genes[16:], cov[16:]
    if case == "nan_loss":
        genes = genes.copy()
        genes[30, 3] = np.nan
    else:
        # scripted R2, the same in both packages
        script = {"nan_r2": [0.1, 0.2, np.nan],
                  "early_stop": [0.1, 0.2, 0.15, 0.1, 0.05, 0.3]}[case]
        for mod in (j_sweep, t_sweep):
            seq = iter(script)
            monkeypatch.setattr(mod, "evaluate_r2_tx_adapting",
                                lambda *a, seq=seq: next(seq))
    rkw = {"num_epochs": 20, "checkpoint_freq": 1, "max_minutes": 10,
           "batch_size": BATCH, "patience": 1}
    jr, tr = run_both({"lr": 1e-3, "seed": 0}, rkw, genes, cov,
                      test_genes, test_cov)
    assert_same_history(jr, tr)
    want = {"nan_loss": ("nan_r2", 1), "nan_r2": ("nan_r2", 4),
            "early_stop": ("early_stop", 5)}[case]
    assert (tr["stop_reason"], tr["epochs_run"]) == want
    assert (tr["best_variables"] is None) == (case == "nan_loss")


# ---------------------------------------------------------------- the CLIs
def test_sweep_clis_match_jax(tmp_path, monkeypatch):
    """One config: the JAX CLI initializes each config's model op by op
    (3-4 s of compiles on the CPU); the expansion is tested above."""
    js = tmp_path / "sweep.json"
    write_sweep_json(js)
    sweep = json.loads(js.read_text())
    sweep["grid"]["model.hparams.autoencoder_width"]["options"] = [24]
    js.write_text(json.dumps(sweep))
    seen = {}
    for name, mod in (("jax", j_sweep), ("port", t_sweep)):
        orig = mod.run_chemcpa_sweep

        def record(configs, *arrays, orig=orig, name=name, **kw):
            seen[name] = (configs, arrays)
            return orig(configs, *arrays, **kw)

        monkeypatch.setattr(mod, "run_chemcpa_sweep", record)
    argv = ["--sweep_yaml", str(js), "--synthetic", "--synthetic_drugs",
            "12", "--synthetic_scale", "--epoch_cap", "2", "--seed", "3",
            "--platform", "cpu"]
    jout = j_cli.main(argv + ["--save_dir", str(tmp_path / "j")])
    tout = t_cli.main(argv + ["--save_dir", str(tmp_path / "t")])
    assert seen["port"][0] == seen["jax"][0] and len(seen["port"][0]) == 1
    for got, want in zip(seen["port"][1], seen["jax"][1]):
        np.testing.assert_array_equal(got, want)
    genes, _ = t_cli.tx_rows(make_dataset(num_drugs=12, seed=3))
    assert len(seen["port"][1][0]) + len(seen["port"][1][2]) == len(genes)
    assert len(tout["results"]) == len(jout["results"]) == 1

    def lines(d):
        with open(tmp_path / d / "sweep_results.jsonl") as f:
            return [sorted(json.loads(l)) for l in f]

    assert lines("t") == lines("j")
    # the best encoder overlays onto a flagship-shaped encoder's tx module
    sd, cfg = load_checkpoint(tout["checkpoint"])
    assert isinstance(cfg, t_config.ChemCPAConfig)
    assert cfg.autoencoder_width == tout["best_config"].autoencoder_width
    ds = make_dataset(num_drugs=12, num_labels=4, num_edges=20, seed=3)
    enc = MadrigalEncoder(t_config.EncoderConfig(
        feature_dim=8, chemcpa=t_config.ChemCPAConfig(
            dim=8, autoencoder_width=cfg.autoencoder_width,
            autoencoder_depth=cfg.autoencoder_depth)),
        *kg_schema(ds.kg_node_feats, ds.kg_edge_indices))
    merged = overlay_stage1_checkpoint(enc.state_dict(), sd)
    taken = [k for k in sd if k in merged]
    assert taken and all(torch.equal(merged[k], sd[k]) for k in taken)
    assert all(k.startswith("tx_encoder.") for k in sd)
