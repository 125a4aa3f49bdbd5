"""Shared CLI plumbing (port of `madrigal_tpu/cli/common.py`): the same
flags, device setup and data loading.

`--platform` takes `cpu` or `cuda` (default `cuda`); `tpu` raises. The
TPU layout flag `--kg_chunk` still parses and selects the plain KG
layout. In training, `--no_src_mxu` drops the source-sorted KG layout, so
the HGT's source-gather backward is the plain `index_add_` instead of
kernel K2 (stage 2 and stage 3 train on that layout by default); serving
runs no backward and never builds it.
`--from_yaml` and `--set` override a training config (`apply_overrides`;
the YAML loader needs pyyaml, `--set` nothing); serving takes its config
from the checkpoint. `--data_dir` reads a reference-format data directory
(`data/datasets.py`): serving and training both take its drugs, KG and
`split_by_triplets/train_df.csv`.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Tuple

import numpy as np
import torch

from .. import config as config_lib
from ..data.collate import DDICollator
from ..data.synthetic import (
    SyntheticDataset,
    make_dataset,
    make_reference_scale_dataset,
)
from ..device import resolve_device


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--from_yaml", type=str, default=None,
                   help="YAML config overrides (dotted keys supported)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. "
                        "--set model.encoder.transformer.num_layers=2")
    p.add_argument("--synthetic", action="store_true",
                   help="run on the built-in synthetic miniature dataset")
    p.add_argument("--synthetic_drugs", type=int, default=32)
    p.add_argument("--synthetic_labels", type=int, default=12)
    p.add_argument("--synthetic_edges", type=int, default=120)
    p.add_argument("--synthetic_scale", action="store_true",
                   help="reference-scale synthetic dataset (6,843 drugs, "
                        "960 outcomes, the PrimeKG-scale 8.3M-edge KG)")
    p.add_argument("--synthetic_scale_shrink", type=int, default=1,
                   help="divide every --synthetic_scale dimension (drugs, "
                        "outcomes, rows, KG edges) by this factor")
    p.add_argument("--data_dir", type=str, default=None,
                   help="root of a reference-format data directory")
    p.add_argument("--save_dir", type=str, default="./madrigal_output")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--platform", type=str, default="cuda",
                   choices=["cpu", "cuda", "tpu"],
                   help="device to run on (default cuda; cpu for local "
                        "debugging; tpu is the JAX package's)")
    p.add_argument("--kg_chunk", type=int, default=8,
                   help="TPU degree-chunked KG layout; parsed for flag "
                        "compatibility, the plain layout is used")
    p.add_argument("--no_src_mxu", action="store_true",
                   help="training: drop the source-sorted KG layout, "
                        "so the HGT's source-gather backward runs as a "
                        "plain gather's instead of the sorted segment-sum "
                        "kernel K2; that backward adds with atomics on the "
                        "card and does not repeat from run to run (the "
                        "destination-side sums stay on K2; serving never "
                        "builds the source layout)")

def _parse_value(v: str):
    # Python-style bool/None spellings first: json.loads("False") fails,
    # and the raw string "False" would read as true
    low = v.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return json.loads(v)
    except json.JSONDecodeError:
        return v


def apply_overrides(cfg: Any, args: argparse.Namespace) -> Any:
    """`--from_yaml` first, then every `--set KEY=VALUE` (dotted keys,
    JSON values), onto a dataclass config."""
    if args.from_yaml:
        cfg = config_lib.load_yaml_overrides(cfg, args.from_yaml)
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = _parse_value(v)
    if overrides:
        cfg = config_lib.override(cfg, overrides)
    return cfg


def refuse_graph_parallel(enc_cfg) -> None:
    """The training CLIs run one process: an HGT with `shard_axis` set
    trains graph-parallel only under `parallel/train_step`
    (shard_finetune_trainer / shard_cl_pretrainer with kg_shard_axis),
    which sets the axis itself. Raise before anything is written."""
    if enc_cfg.hgt.shard_axis is not None:
        raise NotImplementedError(
            f"hgt.shard_axis={enc_cfg.hgt.shard_axis!r}: the training "
            "CLIs run one process; train graph-parallel through "
            "madrigal_tpu_torch.parallel.train_step (kg_shard_axis)")


def setup_platform(args: argparse.Namespace) -> torch.device:
    """The run's device. CUDA turns TF32 off (float32 stays float32)."""
    if args.platform == "tpu":
        raise NotImplementedError(
            "--platform tpu belongs to the JAX package (madrigal_tpu); "
            "this package runs on cuda or cpu")
    return resolve_device(args.platform)


def reference_scale_kwargs(shrink: int) -> dict:
    """make_reference_scale_dataset's size arguments for
    --synthetic_scale_shrink `shrink`: every dimension divided by it."""
    s = shrink or 1
    if s > 1:
        return dict(num_drugs=max(6843 // s, 16), num_labels=max(960 // s, 8),
                    num_rows=max(174_763 // s, 64), kg_scale=s)
    return {}


def reference_scale_dataset(args: argparse.Namespace) -> SyntheticDataset:
    """The --synthetic_scale dataset, every dimension divided by
    --synthetic_scale_shrink."""
    return make_reference_scale_dataset(
        seed=args.seed, **reference_scale_kwargs(args.synthetic_scale_shrink))


def tx_rows(ds) -> Tuple[np.ndarray, np.ndarray]:
    """The tx signatures [C, N, G] as (genes [R, G] float32, cell line
    [R] int32) rows, only the available ones when any is: the rows of
    stage 1's tx adaptation and of the chemCPA sweep."""
    C, N, G = ds.tx_table.shape
    genes = ds.tx_table.reshape(C * N, G).astype(np.float32)
    cov = np.repeat(np.arange(C, dtype=np.int32), N)
    avail = ds.mod_avail[:, -C:].T.reshape(-1) == 1
    if avail.any():
        genes, cov = genes[avail], cov[avail]
    return genes, cov


def load_data(args: argparse.Namespace, device: torch.device,
              kg_src_sort: bool = False
              ) -> Tuple[SyntheticDataset, DDICollator]:
    """The dataset and its collator: --synthetic_scale, the small
    synthetic dataset, or --data_dir's reference-format data (the loader's
    defaults: TWOSIDES, split_by_triplets, train). The KG batch is sorted
    by destination with the layouts kernel K2 sums over, and with
    `kg_src_sort` also carries the source-sorted one that the training
    backward reduces with K2 (the training CLIs ask for it unless
    --no_src_mxu). Serving leaves that one out: it runs no backward, and
    its host argsorts would only delay the first score."""
    if args.synthetic_scale:
        ds = reference_scale_dataset(args)
    elif args.synthetic or not args.data_dir:
        ds = make_dataset(
            num_drugs=args.synthetic_drugs,
            num_labels=args.synthetic_labels,
            num_edges=args.synthetic_edges,
            seed=args.seed,
        )
    else:
        from ..data.datasets import load_reference_dataset

        ds = load_reference_dataset(args.data_dir)
    coll = DDICollator(ds, split="train", seed=args.seed, device=device,
                       kg_src_sort=kg_src_sort)
    return ds, coll
