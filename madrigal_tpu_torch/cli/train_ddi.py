"""DDI finetune entry point, stage 3 (port of `madrigal_tpu/cli/train_ddi.py`;
reference train_ddi_batch.py:419-518): full-batch training with
per-epoch mask resampling, a `last_model` checkpoint, and `--resume`.

Usage:
  python -m madrigal_tpu_torch.cli.train_ddi --synthetic --num_epochs 50 \\
      --finetune_mode str_random_sample --evaluate_interval 0
  (add --platform cpu to run without a card)

It takes the JAX CLI's flags. Not ported yet, and raising
NotImplementedError before training starts: the evaluation sweep (an
`--evaluate_interval` that reaches an evaluation epoch), `--test`,
`--patience`, `--checkpoint` (a stage-2 warm start), `--all_train` and
`--data_dir`. The memory flags act as in the JAX package:
`--fusion_remat` / `--fusion_remat_policy` rematerialize the fusion
transformer, `hgt.remat_edge_types` (`--set`; `--no_hgt_remat` turns it
off) each HGT edge type's messages, and `--fusion_chunk` chunks the
fusion transformer's drug axis. The trainer always runs each forward's
backward before the next forward and shares one KG pass across the
forwards, so no two forwards' activations are ever kept together: that
is what `--remat_forwards` and `--split_forwards` ask for, and they, like
`--no_share_kg`, change nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .. import config as config_lib
from ..config import TrainConfig
from .common import (
    add_common_args,
    apply_overrides,
    reference_scale_dataset,
    setup_platform,
)

_UNPORTED = {
    "test": "the evaluation sweep (Evaluator, eval/metrics.py)",
    "patience": "the evaluation sweep (Evaluator, eval/metrics.py)",
    "checkpoint": "stage-2 modules (the contrastive-pretrain warm start)",
    "all_train": "reference-format data loading (data/datasets.py)",
    "data_dir": "reference-format data loading (data/datasets.py)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Madrigal-TPU DDI finetuning "
                                            "(PyTorch port)")
    add_common_args(p)
    p.add_argument("--finetune_mode", type=str, default="str_random_sample")
    p.add_argument("--split_method", type=str,
                   default="split_by_triplets")
    p.add_argument("--test", action="store_true",
                   help="final test-split evaluation (not ported yet)")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--warmup_epochs", type=int, default=None)
    p.add_argument("--evaluate_interval", type=int, default=None,
                   help="epochs between evaluation sweeps (not ported "
                        "yet: 0 or one that no epoch reaches)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="CL-pretrain checkpoint to warm-start encoders "
                        "from (not ported yet)")
    p.add_argument("--use_pretrained_adaptor", action="store_true")
    p.add_argument("--train_with_str_str", action="store_true")
    p.add_argument("--all_train", action="store_true",
                   help="train on the union of all splits (not ported yet)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint of this CLI to resume from (weights, "
                        "batch statistics, optimizer state, epoch)")
    p.add_argument("--patience", type=int, default=None,
                   help="early-stopping patience (not ported yet)")
    p.add_argument("--eval_types", type=str, default=None)
    p.add_argument("--frozen", action="store_true",
                   help="freeze the encoder; train the decoder only")
    p.add_argument("--label_chunk", type=int, default=None,
                   help="label-chunked training-triple layout (same "
                        "numerics; 0 = one weight gather per triple; "
                        "default 64 unless the config sets "
                        "label_chunk_triples)")
    p.add_argument("--split_forwards", action="store_true",
                   help="parsed; the trainer always backpropagates each "
                        "forward at once")
    p.add_argument("--no_share_kg", action="store_true",
                   help="parsed; the trainer always shares one KG pass")
    p.add_argument("--fusion_chunk", type=int, default=None,
                   help="drug-axis fusion-transformer chunk (exact)")
    p.add_argument("--fusion_remat", action="store_true",
                   help="recompute the fusion transformer in the backward "
                        "(keeps only its embed-width inputs)")
    p.add_argument("--fusion_remat_policy", type=str, default=None,
                   choices=["dots", "none", "all"],
                   help="with --fusion_remat, inside each layer: 'dots' "
                        "(the config default) keeps the Linear outputs, "
                        "'none' recomputes everything, 'all' keeps "
                        "everything")
    p.add_argument("--remat_forwards", action="store_true",
                   help="parsed; the trainer never keeps two forwards' "
                        "activations together, which is what it asks for")
    p.add_argument("--no_hgt_remat", action="store_true",
                   help="turn off hgt.remat_edge_types (keep every HGT "
                        "edge type's edge buffers for the backward)")
    return p


def build_config(args: argparse.Namespace, num_labels: int) -> TrainConfig:
    """The run's TrainConfig: defaults, then --from_yaml and --set, then
    the explicit flags (the JAX CLI's order)."""
    cfg = apply_overrides(
        TrainConfig(seed=args.seed, finetune_mode=args.finetune_mode), args)
    for field in ("num_epochs", "warmup_epochs", "evaluate_interval"):
        v = getattr(args, field)
        if v is not None:
            cfg = dataclasses.replace(cfg, **{field: v})
    enc = cfg.model.encoder
    if args.fusion_chunk is not None:
        enc = dataclasses.replace(enc,
                                  fusion_batch_chunk=args.fusion_chunk or None)
    if args.fusion_remat:
        enc = dataclasses.replace(enc, transformer=dataclasses.replace(
            enc.transformer, remat=True))
    if args.fusion_remat_policy is not None:
        enc = dataclasses.replace(enc, transformer=dataclasses.replace(
            enc.transformer, remat_policy=(
                None if args.fusion_remat_policy == "none"
                else args.fusion_remat_policy)))
    if args.no_hgt_remat:
        enc = dataclasses.replace(enc, hgt=dataclasses.replace(
            enc.hgt, remat_edge_types=False))
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, prediction_dim=num_labels,
                                  encoder=enc),
        train_with_str_str=args.train_with_str_str,
        frozen=args.frozen or cfg.frozen,
        label_chunk_triples=(args.label_chunk if args.label_chunk is not None
                             else (cfg.label_chunk_triples or 64)),
        split_forward_grads=args.split_forwards or cfg.split_forward_grads,
        split_share_kg_table=(not args.no_share_kg
                              and cfg.split_share_kg_table),
        remat_forwards=args.remat_forwards or cfg.remat_forwards,
    )
    config_lib.validate(cfg)
    return cfg


def _load_train_data(args, device):
    """(dataset with the train rows, train collator): the reference-scale
    data split 80/10/10 by rows and collated against the full drug table,
    or the small synthetic dataset's train split."""
    from ..data.collate import DDICollator
    from ..data.synthetic import make_split_dataset

    if args.synthetic_scale:
        ds = reference_scale_dataset(args)
        perm = np.random.RandomState(args.seed).permutation(len(ds.edge_df))
        ds.edge_df = ds.edge_df.take(perm[2 * (len(perm) // 10):])
        return ds, DDICollator(ds, split="train", seed=args.seed,
                               device=device,
                               kg_src_sort=not args.no_src_mxu,
                               drug_table_cache={}, full_drug_table=True)
    ds, _ = make_split_dataset(
        num_drugs=args.synthetic_drugs, num_labels=args.synthetic_labels,
        num_edges=args.synthetic_edges, split_method=args.split_method,
        seed=args.seed)
    return ds, DDICollator(ds, split="train", seed=args.seed, device=device,
                           kg_src_sort=not args.no_src_mxu,
                           drug_table_cache={})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train; returns {"losses": per-epoch loss dicts, "epoch_seconds",
    "data_seconds", "checkpoint": the last_model path}."""
    args = build_parser().parse_args(argv)
    for flag, item in _UNPORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP: {item})")
    device = setup_platform(args)

    from ..data.kg import kg_schema
    from ..models.encoder import build_model, init_weights
    from ..train.checkpoint import (
        check_finite_loss,
        load_checkpoint,
        load_train_state,
        save_checkpoint,
    )
    from ..train.finetune import FinetuneTrainer
    from ..utils.logging import MetricLogger, get_root_logger

    os.makedirs(args.save_dir, exist_ok=True)
    logger = get_root_logger(os.path.join(args.save_dir, "train_ddi.log"))
    mlog = MetricLogger(args.save_dir, run_name="train_ddi")

    t0 = time.perf_counter()
    ds, coll = _load_train_data(args, device)
    cfg = build_config(args, ds.num_labels)
    start_epoch, opt_state = 0, None
    if args.resume:
        start_epoch, opt_state, _ = load_train_state(args.resume)
    interval = cfg.evaluate_interval
    if interval > 0 and any(e > 0 and e % interval == 0
                            for e in range(start_epoch, cfg.num_epochs)):
        raise NotImplementedError(
            f"--evaluate_interval {interval} reaches an evaluation epoch; "
            "the evaluation sweep is not ported yet (ROADMAP: Evaluator "
            "and eval/metrics.py); pass --evaluate_interval 0")
    logger.info(f"config:\n{config_lib.dumps(cfg)}")

    batch, kg = coll()
    model = build_model(cfg.model,
                        *kg_schema(ds.kg_node_feats, ds.kg_edge_indices),
                        device="cpu")
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    if args.resume:
        model.load_state_dict(load_checkpoint(args.resume)[0], strict=True)
    trainer = FinetuneTrainer(cfg, batch, kg, model.to(device))
    if args.resume:
        trainer.load_training_state(opt_state, start_epoch)
        logger.info(f"resumed from {args.resume} at epoch {start_epoch}")
    _sync(device)
    data_seconds = time.perf_counter() - t0
    logger.info(f"data and model on {device}: {data_seconds:.3f} s")

    history, epoch_seconds = [], []
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.perf_counter()
        losses = check_finite_loss(trainer.train_epoch())
        _sync(device)
        epoch_seconds.append(time.perf_counter() - t0)
        history.append(losses)
        mlog.log({f"train_{k}": v for k, v in losses.items()}, step=epoch)
        logger.info(f"epoch {epoch + 1}/{cfg.num_epochs}: "
                    f"loss={losses['total']:.4f} "
                    f"({epoch_seconds[-1]:.3f} s)",
                    extra={"phase": f"epoch_{epoch + 1}",
                           "seconds": epoch_seconds[-1]})

    path = os.path.join(args.save_dir, "last_model")
    save_checkpoint(path, trainer.model, cfg, epoch=cfg.num_epochs,
                    opt_state=trainer.training_state())
    logger.info(f"wrote {path}")
    mlog.finish()
    return {"losses": history, "epoch_seconds": epoch_seconds,
            "data_seconds": data_seconds, "checkpoint": path}


if __name__ == "__main__":
    main()
