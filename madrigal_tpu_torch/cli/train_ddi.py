"""DDI finetune entry point, stage 3 (port of `madrigal_tpu/cli/train_ddi.py`;
reference train_ddi_batch.py:419-518): full-batch training with
per-epoch mask resampling, an evaluation sweep every `evaluate_interval`
epochs on the held-out splits (`Evaluator`, eval/evaluate.py) that keeps
the `best_model` / `best_within_model` checkpoints and stops early after
`--patience` sweeps without a gain, a `last_model` checkpoint,
`--resume`, and with `--test` a final test-split sweep of the best model.

Usage:
  python -m madrigal_tpu_torch.cli.train_ddi --synthetic --num_epochs 50 \\
      --finetune_mode str_random_sample --evaluate_interval 10 --test
  (add --platform cpu to run without a card)

It takes the JAX CLI's flags. `--data_dir` trains on a reference-format
data directory (`data/datasets.py`) and evaluates on its held-out split
tables, `--all_train` trains on the union of the split_by_pairs tables,
and `--checkpoint` warm-starts the encoders from a stage-2 checkpoint
(`--use_pretrained_adaptor` also keeps its uni projector; a JAX stage-2
run is carried over with `interop.from_flax.stage2_checkpoint_from_flax`).
`--eval_types` narrows
every sweep to the given eval types. The memory flags act as in the JAX
package:
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
    refuse_graph_parallel,
    setup_platform,
)

# the held-out split tables a --data_dir run evaluates on, where present
DATA_DIR_EVAL_SPLITS = ("val", "test", "val_between", "val_within",
                        "test_between", "test_within")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Madrigal-TPU DDI finetuning "
                                            "(PyTorch port)")
    add_common_args(p)
    p.add_argument("--finetune_mode", type=str, default="str_random_sample")
    p.add_argument("--split_method", type=str,
                   default="split_by_triplets")
    p.add_argument("--test", action="store_true",
                   help="final test-split evaluation with the best model"
                        " (reference predict.test analog)")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--warmup_epochs", type=int, default=None)
    p.add_argument("--evaluate_interval", type=int, default=None,
                   help="epochs between evaluation sweeps (0: none)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="stage-2 (contrastive pretraining) checkpoint to "
                        "warm-start the encoders from")
    p.add_argument("--use_pretrained_adaptor", action="store_true",
                   help="with --checkpoint, also take its uni projector")
    p.add_argument("--train_with_str_str", action="store_true")
    p.add_argument("--all_train", action="store_true",
                   help="train on the union of all splits "
                        "(train_ddi_batch_all_train.py analog)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint of this CLI to resume from (weights, "
                        "batch statistics, optimizer state, epoch)")
    p.add_argument("--patience", type=int, default=None,
                   help="early-stopping patience in evaluation sweeps on "
                        "the val key metric (off when unset)")
    p.add_argument("--eval_types", type=str, default=None,
                   help="comma-separated eval-type override; default sweeps "
                        "the full per-split SPLIT_EVAL_TYPES lists "
                        "(reference evaluate.py:39-247)")
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
    refuse_graph_parallel(cfg.model.encoder)
    return cfg


def _load_train_data(args, device):
    """(dataset with the train rows, train collator, {split: rows}), as
    the JAX CLI chooses them:

    * --all_train: the union of the split_by_pairs train/val/test tables
      of --data_dir, with no held-out split; without --data_dir (or with
      --synthetic), of the small synthetic dataset's split_by_pairs
      splits, which are then also evaluated on;
    * --synthetic_scale: the reference-scale data split 80/10/10 by rows
      (val, test, train) and collated against the full drug table;
    * --synthetic, or no --data_dir: the small synthetic dataset's split
      family;
    * --data_dir: the reference-format data. It trains on
      split_by_triplets/train_df.csv whatever --split_method says, as the
      JAX CLI does (its data loading takes the loader's defaults), and
      evaluates on --split_method's held-out tables that are present."""
    from ..data.collate import DDICollator
    from ..data.synthetic import make_split_dataset

    full_drug_table = False
    if args.all_train and args.data_dir and not args.synthetic:
        from ..data.datasets import load_reference_all_train

        ds, splits = load_reference_all_train(args.data_dir), {}
    elif args.all_train:
        from ..data.datasets import union_edge_tables

        ds, splits = make_split_dataset(
            num_drugs=args.synthetic_drugs, num_labels=args.synthetic_labels,
            num_edges=args.synthetic_edges, split_method="split_by_pairs",
            seed=args.seed)
        ds.edge_df = union_edge_tables(list(splits.values()))
    elif args.synthetic_scale:
        ds = reference_scale_dataset(args)
        df = ds.edge_df
        perm = np.random.RandomState(args.seed).permutation(len(df))
        n_hold = len(df) // 10
        splits = {"val": df.take(perm[:n_hold]),
                  "test": df.take(perm[n_hold:2 * n_hold])}
        ds.edge_df = df.take(perm[2 * n_hold:])
        full_drug_table = True
    elif args.synthetic or not args.data_dir:
        ds, splits = make_split_dataset(
            num_drugs=args.synthetic_drugs, num_labels=args.synthetic_labels,
            num_edges=args.synthetic_edges, split_method=args.split_method,
            seed=args.seed)
    else:
        from ..data.datasets import load_edge_table, load_reference_dataset

        ds = load_reference_dataset(args.data_dir)
        splits = {}
        for split in DATA_DIR_EVAL_SPLITS:
            try:
                splits[split] = load_edge_table(
                    args.data_dir, split_method=args.split_method,
                    split=split)
            except FileNotFoundError:
                pass
    return ds, DDICollator(ds, split="train", seed=args.seed, device=device,
                           kg_src_sort=not args.no_src_mxu,
                           drug_table_cache={},
                           full_drug_table=full_drug_table), splits


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train; returns {"losses": per-epoch loss dicts, "epoch_seconds",
    "data_seconds", "checkpoint": the last_model path, "best_key",
    "best_epoch", "best_within_key", "best_within_epoch", "eval_seconds"
    and "eval_keys" (per sweep), "stopped_epoch" (None unless stopped
    early), "test_keys" ({split: key metric of the best model}) and
    "test_seconds"}."""
    args = build_parser().parse_args(argv)
    device = setup_platform(args)

    from ..data.collate import DDICollator
    from ..data.kg import kg_schema
    from ..eval.evaluate import Evaluator
    from ..eval.predict import model_from_checkpoint
    from ..models.encoder import build_model, init_weights
    from ..train.checkpoint import (
        EarlyStopping,
        check_finite_loss,
        load_checkpoint,
        load_train_state,
        save_checkpoint,
        warm_start_encoder,
    )
    from ..train.finetune import FinetuneTrainer, training_model_config
    from ..utils.logging import MetricLogger, get_root_logger

    os.makedirs(args.save_dir, exist_ok=True)
    logger = get_root_logger(os.path.join(args.save_dir, "train_ddi.log"))
    mlog = MetricLogger(args.save_dir, run_name="train_ddi")

    t0 = time.perf_counter()
    ds, coll, splits = _load_train_data(args, device)
    cfg = build_config(args, ds.num_labels)
    start_epoch, opt_state, extra = 0, None, {}
    if args.resume:
        start_epoch, opt_state, extra = load_train_state(args.resume)
    logger.info(f"config:\n{config_lib.dumps(cfg)}")

    batch, kg = coll()
    model = build_model(training_model_config(cfg),
                        *kg_schema(ds.kg_node_feats, ds.kg_edge_indices),
                        device="cpu")
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    if args.checkpoint:
        stage2, _ = load_checkpoint(args.checkpoint)
        kept = warm_start_encoder(model, stage2, args.use_pretrained_adaptor)
        logger.info(f"warm-started {len(kept)} encoder parameters from "
                    f"{args.checkpoint} (uni projector "
                    f"{'kept' if args.use_pretrained_adaptor else 'fresh'})")
    if args.resume:
        model.load_state_dict(load_checkpoint(args.resume)[0], strict=True)
    trainer = FinetuneTrainer(cfg, batch, kg, model.to(device))
    # restore the best-model tracking, so that the first sweep after a
    # resume cannot overwrite a better best_model from before it
    best_key = float(extra.get("best_key", -1e8))
    best_within_key = float(extra.get("best_within_key", -1e8))
    best_epoch = extra.get("best_epoch")
    best_within_epoch = extra.get("best_within_epoch")
    if args.resume:
        trainer.load_training_state(opt_state, start_epoch)
        logger.info(f"resumed from {args.resume} at epoch {start_epoch} "
                    f"(best so far {best_key:.4f} @ {best_epoch})")

    evaluator = Evaluator(trainer.model, cfg.finetune_mode, task=cfg.task,
                          logger=logger)
    eval_types = ([t for t in args.eval_types.split(",") if t]
                  if args.eval_types else None)

    # the eval and test collators share the train collator's drug-table
    # cache and score against the train `kg` (the graph does not depend on
    # the split); val batches are built once here, test batches only in
    # the --test block
    def _eval_collator(name):
        return DDICollator(ds, split=name, seed=args.seed, device=device,
                           drug_table_cache=coll.drug_table_cache,
                           full_drug_table=coll.full_drug_table)

    eval_batches, test_dfs = {}, {}
    for name, df in splits.items():
        if name == "train" or not len(df):
            continue
        if name.startswith("test"):
            test_dfs[name] = df
        else:
            eval_batches[name] = _eval_collator(name)(df, build_kg=False)[0]
    # selection priority: plain 'val' wins when it coexists with
    # val_between (deterministic, not dict insertion order)
    val_splits = sorted([n for n in eval_batches if n.startswith("val")],
                        key=lambda n: (n != "val", n))
    _sync(device)
    data_seconds = time.perf_counter() - t0
    logger.info(f"data and model on {device}: {data_seconds:.3f} s")

    stopper = EarlyStopping(args.patience) if args.patience else None

    def tracking_extra():
        return {"best_key": best_key, "best_within_key": best_within_key,
                "best_epoch": best_epoch,
                "best_within_epoch": best_within_epoch}

    def run_eval_sweep(epoch):
        """The per-split eval-type sweep (reference evaluate.py:39-247);
        saves best_model / best_within_model on a gain. Returns the val
        key metric."""
        nonlocal best_key, best_within_key, best_epoch, best_within_epoch
        key = within_key = None
        if val_splits:
            for name in val_splits:
                k = evaluator.evaluate_ft(eval_batches[name], kg, name,
                                          eval_types=eval_types)
                mlog.log({f"{name}_key_auprc": k}, step=epoch)
                if "within" in name:
                    within_key = k
                elif key is None:  # first in priority order ('val' first)
                    key = k
            if key is None:  # only within splits exist
                key = within_key
        else:
            key = evaluator.evaluate_ft(
                batch, kg, "train",
                eval_types=eval_types or ["full_full", "str_str"])
            mlog.log({"train_key_auprc": key}, step=epoch)
        if key is not None and key > best_key:
            best_key, best_epoch = key, epoch
            save_checkpoint(os.path.join(args.save_dir, "best_model"),
                            trainer.model, cfg, epoch=epoch,
                            opt_state=trainer.training_state(),
                            extra=tracking_extra())
            logger.info(f"new best auprc {key:.4f} @ epoch {epoch}")
        if within_key is not None and within_key > best_within_key:
            best_within_key, best_within_epoch = within_key, epoch
            save_checkpoint(os.path.join(args.save_dir, "best_within_model"),
                            trainer.model, cfg, epoch=epoch,
                            opt_state=trainer.training_state())
            logger.info(
                f"new best within auprc {within_key:.4f} @ epoch {epoch}")
        return key

    path = os.path.join(args.save_dir, "last_model")
    history, epoch_seconds, eval_seconds, eval_keys = [], [], [], []
    stopped_epoch = None
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
        # evaluate_interval <= 0: no sweep during the run
        if (cfg.evaluate_interval > 0 and epoch > 0
                and epoch % cfg.evaluate_interval == 0):
            t0 = time.perf_counter()
            key = run_eval_sweep(epoch)
            eval_seconds.append(time.perf_counter() - t0)
            eval_keys.append(key)
            logger.info(f"evaluation sweep @ epoch {epoch}: key {key:.4f} "
                        f"({eval_seconds[-1]:.3f} s)",
                        extra={"phase": f"eval_{epoch}",
                               "seconds": eval_seconds[-1]})
            # resumable snapshot (weights, optimizer state, epoch)
            save_checkpoint(path, trainer.model, cfg, epoch=epoch + 1,
                            opt_state=trainer.training_state(),
                            extra=tracking_extra())
            if stopper is not None and stopper(key):
                logger.info(
                    f"early stop @ epoch {epoch}: no val improvement in "
                    f"{args.patience} eval intervals")
                stopped_epoch = epoch
                break

    if stopped_epoch is None:
        save_checkpoint(path, trainer.model, cfg, epoch=cfg.num_epochs,
                        opt_state=trainer.training_state(),
                        extra=tracking_extra())
    logger.info(f"wrote {path}; best auprc {best_key:.4f} @ epoch "
                f"{best_epoch}; best within {best_within_key:.4f} @ epoch "
                f"{best_within_epoch}")

    test_keys, test_seconds = {}, None
    best_path = os.path.join(args.save_dir, "best_model")
    if args.test and test_dfs and os.path.exists(best_path):
        # reference predict.test analog: reload the best checkpoint and run
        # the test-split sweep (predict.py:15-170)
        t0 = time.perf_counter()
        best, _ = model_from_checkpoint(best_path, device=device)
        test_eval = Evaluator(best, cfg.finetune_mode, task=cfg.task,
                              logger=logger)
        for name in sorted(test_dfs):
            test_batch = _eval_collator(name)(test_dfs[name],
                                              build_kg=False)[0]
            test_keys[name] = test_eval.evaluate_ft(
                test_batch, kg, name, eval_types=eval_types)
            logger.info(f"{name} key auprc (best model): "
                        f"{test_keys[name]:.4f}")
            mlog.log({f"{name}_key_auprc_best": test_keys[name]})
        test_seconds = time.perf_counter() - t0
    mlog.finish()
    return {"losses": history, "epoch_seconds": epoch_seconds,
            "data_seconds": data_seconds, "checkpoint": path,
            "best_key": best_key, "best_epoch": best_epoch,
            "best_within_key": best_within_key,
            "best_within_epoch": best_within_epoch,
            "eval_seconds": eval_seconds, "eval_keys": eval_keys,
            "stopped_epoch": stopped_epoch, "test_keys": test_keys,
            "test_seconds": test_seconds}


if __name__ == "__main__":
    main()
