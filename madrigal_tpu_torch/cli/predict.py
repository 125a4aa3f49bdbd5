"""Prediction / embedding-export entry point (port of
`madrigal_tpu/cli/predict.py`): load a checkpoint, embed all drugs,
export the raw [L, N, N] score tensor (np.memmap), and answer
(outcome, drugA, drugB) triple queries.

Usage:
  python -m madrigal_tpu_torch.cli.predict --checkpoint model.pt \
      --synthetic --export_scores scores.npy --triples 0:1:2 3:4:5
  (add --platform cpu to run without a card)

Not ported yet, and raising NotImplementedError: more than one
checkpoint (the ensemble protocol), --export_ranks, --eval_type,
--ablation and --sharded.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np

from .common import add_common_args, load_data, setup_platform

_UNPORTED = {
    "export_ranks": "eval/ranks.py rank normalization",
    "eval_type": "eval/masks.py evaluation masks",
    "ablation": "eval/ablation.py modality ablation",
    "sharded": "multi-GPU label sharding",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Madrigal-TPU prediction "
                                            "(PyTorch port)")
    add_common_args(p)
    p.add_argument("--checkpoint", type=str, required=True, nargs="+",
                   help="checkpoint path (one; the multi-seed ensemble "
                        "is not ported yet)")
    p.add_argument("--export_embeddings", type=str, default=None)
    p.add_argument("--export_scores", type=str, default=None,
                   help="write the [L, N, N] raw-score tensor (np.memmap)")
    p.add_argument("--export_ranks", type=str, default=None)
    p.add_argument("--keep_seed_ranks", action="store_true")
    p.add_argument("--triples", type=str, nargs="*", default=[],
                   metavar="L:A:B", help="outcome:drugA:drugB queries")
    p.add_argument("--label_chunk", type=int, default=32)
    p.add_argument("--eval_type", type=str, default=None)
    p.add_argument("--finetune_mode", type=str,
                   default="str_random_sample")
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--ablation", type=str, default=None, metavar="OUT_JSON")
    p.add_argument("--ablation_combos", type=str, default=None)
    return p


def _logger() -> logging.Logger:
    logger = logging.getLogger("madrigal_tpu_torch")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)-10s] %(message)s",
                                         "%m/%d/%Y %H:%M:%S"))
        logger.addHandler(h)
    return logger


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, item in _UNPORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP: {item})")
    if len(args.checkpoint) > 1:
        raise NotImplementedError(
            "more than one --checkpoint is not ported yet (ROADMAP: "
            "multi-seed ensembles)")
    device = setup_platform(args)

    from ..eval.predict import (
        embed_all_drugs,
        model_from_checkpoint,
        score_all_pairs,
        score_triples_for_pairs,
    )

    logger = _logger()
    ds, coll = load_data(args, device)
    model, _ = model_from_checkpoint(args.checkpoint[0], device=device)
    kg = coll.kg_batch()
    z = embed_all_drugs(model, coll, kg)
    logger.info(f"embedded {z.shape[0]} drugs -> {z.shape} on {device}")
    if args.export_embeddings:
        np.save(args.export_embeddings, z)
        logger.info(f"wrote {args.export_embeddings}")

    if args.export_scores:
        L = model.decoder.weight.shape[0]
        n = z.shape[0]
        out = np.lib.format.open_memmap(
            args.export_scores, mode="w+", dtype=np.float32, shape=(L, n, n))
        score_all_pairs(model, z, label_chunk=args.label_chunk, out=out)
        out.flush()
        logger.info(f"wrote {args.export_scores}")

    if args.triples:
        triples = [tuple(int(x) for x in t.split(":")) for t in args.triples]
        scores = score_triples_for_pairs(model, z, triples)
        for t, s in zip(triples, scores):
            logger.info(f"outcome={t[0]} drugA={t[1]} drugB={t[2]} "
                        f"score={float(s):.4f}")
        return scores
    return z


if __name__ == "__main__":
    main()
