"""Contrastive pretraining entry point, stage 2 (port of
`madrigal_tpu/cli/pretrain.py`; reference pretrain.py:41-292): drugs with
at least 2 modalities, modality-subset masks drawn each step, SimCLR
InfoNCE, periodic checkpoints `cl_checkpoint_{k}` and the last one
`cl_last`, which `cli.train_ddi --checkpoint` warm-starts from.

Usage:
  python -m madrigal_tpu_torch.cli.pretrain --synthetic --num_steps 100 \\
      --pretrain_mode str_center_uni
  (add --platform cpu to run without a card)

It takes the JAX CLI's flags. Steps run in prefetch-overlapped segments
between checkpoint boundaries, as in the JAX CLI; a checkpoint holds the
model, the optimizer's and the schedule's state, the boundary as its
`epoch` (the JAX CLI's) and the steps taken. `--resume` continues after
the steps taken, with the host draws restarted from the seed as in the
JAX CLI (which restarts at the boundary, one step before the steps
taken). The training backward reduces the HGT's source gather with
kernel K2 unless `--no_src_mxu`. `--modality_ckpts` overlays stage-1
checkpoints (`cli.modality_pretrain`) on the encoder before the first
step, and before `--resume`, as in the JAX CLI (`train/transfer.py`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .. import config as config_lib
from ..config import PretrainConfig
from .common import (
    add_common_args,
    apply_overrides,
    load_data,
    refuse_graph_parallel,
    setup_platform,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Madrigal-TPU CL pretraining "
                                            "(PyTorch port)")
    add_common_args(p)
    p.add_argument("--pretrain_mode", type=str, default="str_center_uni")
    p.add_argument("--pretrain_unbalanced", action="store_true")
    p.add_argument("--raw_encoder_output", action="store_true")
    p.add_argument("--num_steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--save_checkpoints", type=int, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path to resume from (restores params,\n"
                        "batch stats, optimizer state and step count)")
    p.add_argument("--modality_ckpts", type=str, nargs="*", default=[],
                   help="stage-1 checkpoints to warm-start the encoders "
                        "from")
    p.add_argument("--host_collate", action="store_true",
                   help="collate each step's minibatch on the host instead "
                        "of gathering it from the drug table collated onto "
                        "the device once")
    p.add_argument("--final_embeds_eval", action="store_true",
                   help="after training, save per-modality train/val embeds "
                        "and run the per-pair alignment/uniformity/GeomCA "
                        "table (the reference's end-of-pretraining "
                        "save_embeds + evaluate_final_embeds flow, "
                        "pretrain.py:260-265, evaluate.py:456-504)")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Pretrain; returns {"losses" (one a step run), "segment_seconds"
    and "segment_steps" (each prefetched segment's wall seconds and step
    count), "checkpoints" (the cl_checkpoint_{k} paths written),
    "checkpoint" (cl_last), "data_seconds" (data, model and trainer up to
    the first step), "final_embeds_seconds" (None unless
    --final_embeds_eval) and "final_embeds" (its table)}."""
    args = build_parser().parse_args(argv)
    device = setup_platform(args)

    from ..data.kg import kg_schema
    from ..models.encoder import init_weights
    from ..train.checkpoint import (
        check_finite_loss,
        load_checkpoint,
        load_train_state,
        save_checkpoint,
    )
    from ..train.pretrain_cl import CLPretrainer, build_simclr_model
    from ..utils.logging import MetricLogger, get_root_logger

    os.makedirs(args.save_dir, exist_ok=True)
    logger = get_root_logger(os.path.join(args.save_dir, "pretrain.log"))
    mlog = MetricLogger(args.save_dir, run_name="pretrain")

    t0 = time.perf_counter()
    ds, coll = load_data(args, device, kg_src_sort=not args.no_src_mxu)
    cfg = PretrainConfig(
        seed=args.seed,
        pretrain_mode=args.pretrain_mode,
        pretrain_unbalanced=args.pretrain_unbalanced,
        raw_encoder_output=args.raw_encoder_output,
    )
    cfg = apply_overrides(cfg, args)
    if args.batch_size:
        cfg = dataclasses.replace(cfg, pretrain_batch_size=args.batch_size)
    if args.save_checkpoints:
        cfg = dataclasses.replace(cfg, save_checkpoints=args.save_checkpoints)
    config_lib.validate(cfg)
    refuse_graph_parallel(cfg.encoder)
    logger.info(f"config:\n{config_lib.dumps(cfg)}")

    kg = coll.kg_batch()
    model = build_simclr_model(
        cfg, *kg_schema(ds.kg_node_feats, ds.kg_edge_indices))
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    if args.modality_ckpts:
        from ..train.transfer import overlay_stage1_checkpoint

        sd = model.base_encoder.state_dict()
        for ck in args.modality_ckpts:
            sd = overlay_stage1_checkpoint(sd, load_checkpoint(ck)[0])
            logger.info(f"warm-started encoders from {ck}")
        model.base_encoder.load_state_dict(sd, strict=True)
    start_step = 0
    if args.resume:
        model.load_state_dict(load_checkpoint(args.resume)[0], strict=True)
    trainer = CLPretrainer(cfg, coll, kg, model.to(device),
                           device_table=not args.host_collate)
    if args.resume:
        epoch, opt_state, extra = load_train_state(args.resume)
        start_step = int(extra.get("steps", epoch))
        trainer.load_training_state(opt_state, start_step)
        logger.info(f"resumed from {args.resume} at step {start_step}")
    _sync(device)
    data_seconds = time.perf_counter() - t0
    logger.info(f"data and model on {device}: {data_seconds:.3f} s "
                f"({len(trainer.drug_ids)} drugs, batch "
                f"{trainer.batch_size})")

    def save(name: str, epoch: int, steps: int) -> str:
        path = os.path.join(args.save_dir, name)
        save_checkpoint(path, trainer.model, cfg, epoch=epoch,
                        opt_state=trainer.training_state(),
                        extra={"steps": steps})
        return path

    # prefetch-overlapped segments between checkpoint boundaries (the JAX
    # CLI's loop): cl_checkpoint_{b} is written after step b;
    # save_checkpoints <= 0 means no periodic checkpoints
    step = start_step
    sc = cfg.save_checkpoints
    all_losses, seg_seconds, seg_steps, ckpts = [], [], [], []
    while step < args.num_steps:
        if sc > 0:
            boundary = max(step, 1) if max(step, 1) % sc == 0 else (
                (max(step, 1) // sc + 1) * sc)
            seg_end = min(args.num_steps, boundary + 1)
        else:
            boundary, seg_end = None, args.num_steps
        t0 = time.perf_counter()
        losses = trainer.train_steps(seg_end - step)
        seg_seconds.append(time.perf_counter() - t0)
        seg_steps.append(seg_end - step)
        for i, loss in enumerate(losses):
            s = step + i
            check_finite_loss(loss, "cl")
            mlog.log({"cl_loss": loss}, step=s)
            if s % 10 == 0:
                logger.info(f"step {s}: infonce={loss:.4f}")
        all_losses += losses
        step = seg_end
        if (sc > 0 and boundary is not None and boundary > 0
                and step == boundary + 1):
            ckpts.append(save(f"cl_checkpoint_{boundary}", boundary, step))

    last = save("cl_last", args.num_steps, step)
    final_seconds = table = None
    if args.final_embeds_eval:
        t0 = time.perf_counter()
        table = run_final_embeds_eval(trainer, coll, kg, args.save_dir,
                                      logger)
        final_seconds = time.perf_counter() - t0
    logger.info("done")
    mlog.finish()
    return {"losses": all_losses, "segment_seconds": seg_seconds,
            "segment_steps": seg_steps, "checkpoints": ckpts,
            "checkpoint": last, "data_seconds": data_seconds,
            "final_embeds_seconds": final_seconds, "final_embeds": table}


def run_final_embeds_eval(trainer, coll, kg, save_dir: str, logger):
    """End-of-pretraining save_embeds -> evaluate_final_embeds
    (reference: pretrain.py:260-265 -> evaluate.py:456-504). The pretrain
    drugs are split 90/10 train/val from the seed, like the reference's
    fallback (data.py:301, train_test_split(test_size=0.1))."""
    from ..eval.evaluate_pt import evaluate_final_embeds, save_embeds

    rng = np.random.RandomState(trainer.cfg.seed)
    ids = trainer.drug_ids.copy()
    rng.shuffle(ids)
    n_val = max(1, len(ids) // 10)
    val_drugs, train_drugs = np.sort(ids[:n_val]), np.sort(ids[n_val:])

    embeds_dir = os.path.join(save_dir, "final_embeds")
    outputs = save_embeds(
        trainer.model.base_encoder, coll, kg, train_drugs, val_drugs,
        save_dir=embeds_dir,
        raw_encoder_output=trainer.cfg.raw_encoder_output,
    )
    table = evaluate_final_embeds(outputs, save_dir=save_dir, logger=logger)
    logger.info(f"final embeds eval: {len(table)} modality pairs "
                f"(embeds in {embeds_dir})")
    return table


if __name__ == "__main__":
    main()
