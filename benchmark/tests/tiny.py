"""Tiny configurations of the benchmark's cells for CPU tests: the
flagship's modules at narrow widths on a small synthetic dataset, under
a BENCHMARK.json of their own in a temporary directory."""
from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY_DATA = {"num_drugs": 24, "num_labels": 6, "num_rows": 80,
             "kg_scale": 4000, "kg_feat_dim": 16}


def _narrow(enc: dict) -> dict:
    enc = copy.deepcopy(enc)
    enc["feature_dim"] = 32
    enc["gin"].update(hidden_dims=[32, 32], num_mlp_layer=2)
    enc["hgt"].update(hidden_dim=64)
    enc["cv"].update(hidden_dims=[64, 32])
    enc["chemcpa"].update(dim=32, autoencoder_width=64)
    enc["transformer"].update(num_layers=1, att_heads=2, head_dim=16,
                              ffn_dim=64)
    enc["proj"].update(hidden_dims=[64, 64])
    return enc


def configs() -> dict:
    """{config name: the tiny form of the benchmark's configuration}."""
    out = {}
    with open(BENCH / "configs" / "madrigal-twosides-ddi.json") as f:
        ddi = json.load(f)
    ddi["data"] = dict(TINY_DATA)
    ddi["train"]["model"]["encoder"] = _narrow(
        ddi["train"]["model"]["encoder"])
    ddi["train"]["model"]["prediction_dim"] = TINY_DATA["num_labels"]
    ddi["train"]["label_chunk_triples"] = 8
    ddi["ranks"] = {"num_drugs": 20, "num_labels": 64, "dim": 128}
    out["madrigal-twosides-ddi"] = ddi
    with open(BENCH / "configs" / "madrigal-twosides-cl.json") as f:
        cl = json.load(f)
    cl["data"] = dict(TINY_DATA)
    cl["pretrain"]["encoder"] = _narrow(cl["pretrain"]["encoder"])
    cl["pretrain"]["encoder"]["fusion_batch_chunk"] = 4
    out["madrigal-twosides-cl"] = cl
    return out


# limits at these sizes on the CPU: the port's plain path reads loss gaps
# of about 1e-7, first-gradient gaps of 1e-6 and change gaps of 2e-3
# (Adam's steps of up to lr on leaves of a few values), rank shifts of 0;
# TF32 rounding reads first-gradient gaps of 1e-2 and more and rank
# shifts of 2, a planted fault gaps of 0.2 to 1 or a broken permutation
LIMITS = {"twosides-ddi-train": {"loss_gap": 1e-5, "grad_gap": 1e-4,
                                  "change_gap": 5e-2},
          "twosides-rank-device": {"rank_shift": 0.5, "rank_errors": 0.0}}
LIMITS["twosides-cl-pretrain"] = dict(LIMITS["twosides-ddi-train"])


def run_cell(root: Path, workload: str, seed: int = 3_000_000_007,
             trace: int = 0) -> dict:
    """One CPU run of `workload` at the tiny sizes, under LIMITS."""
    import torch

    import run

    return run.run(["--workload", workload, "--seed", str(seed),
                    "--seconds", "0.5", "--trace", str(trace)],
                   device=torch.device("cpu"), root=root,
                   limits=dict(LIMITS[workload]))


def write_root(tmp: Path) -> Path:
    """A checkout root in `tmp` with the benchmark's BENCHMARK.json, its
    configuration files replaced by the tiny ones."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    for name, cfg in configs().items():
        path = tmp / "configs" / f"{name}.json"
        path.write_text(json.dumps(cfg))
        for c in bench["configs"]:
            if c["name"] == name:
                c["file"] = str(path.relative_to(tmp))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
