"""Shared CLI plumbing (port of `madrigal_tpu/cli/common.py`): the same
flags, device setup and data loading.

`--platform` takes `cpu` or `cuda` (default `cuda`); `tpu` raises. The
TPU layout flags `--kg_chunk` and `--no_src_mxu` still parse and select
the plain KG layout. `--from_yaml` and `--set` parse too; they override
a training config, and serving takes its config from the checkpoint.
"""
from __future__ import annotations

import argparse
from typing import Tuple

import torch

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
                   help="TPU source-sorted KG layout switch; parsed for "
                        "flag compatibility, no effect")


def setup_platform(args: argparse.Namespace) -> torch.device:
    """The run's device. CUDA turns TF32 off (float32 stays float32)."""
    if args.platform == "tpu":
        raise NotImplementedError(
            "--platform tpu belongs to the JAX package (madrigal_tpu); "
            "this package runs on cuda or cpu")
    return resolve_device(args.platform)


def load_data(args: argparse.Namespace, device: torch.device
              ) -> Tuple[SyntheticDataset, DDICollator]:
    if args.synthetic_scale:
        s = args.synthetic_scale_shrink or 1
        if s > 1:
            ds = make_reference_scale_dataset(
                seed=args.seed,
                num_drugs=max(6843 // s, 16),
                num_labels=max(960 // s, 8),
                num_rows=max(174_763 // s, 64),
                kg_scale=s,
            )
        else:
            ds = make_reference_scale_dataset(seed=args.seed)
    elif args.synthetic or not args.data_dir:
        ds = make_dataset(
            num_drugs=args.synthetic_drugs,
            num_labels=args.synthetic_labels,
            num_edges=args.synthetic_edges,
            seed=args.seed,
        )
    else:
        raise NotImplementedError(
            "--data_dir: reference-format data loading (data/datasets.py) "
            "is not ported yet (ROADMAP)")
    coll = DDICollator(ds, split="train", seed=args.seed, device=device)
    return ds, coll
