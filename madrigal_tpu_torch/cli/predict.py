"""Prediction / embedding-export entry point (port of
`madrigal_tpu/cli/predict.py`; reference notebooks/generate_embeddings.ipynb
and madrigal/evaluate/predict.py): load checkpoint(s), embed all drugs,
export the raw [L, N, N] score tensor and/or the normalized-rank tensor
(np.memmap), run the modality-ablation study, and answer (outcome, drugA,
drugB) triple queries.

Passing MULTIPLE --checkpoint paths runs the published multi-seed
ensemble protocol (reference generate_embeddings.ipynb cells 18-20,
predict.py:466-499,582-614):
  * --export_ranks: per-seed normalized-rank tensors written to
    <out>.seedK.npy, their geometric mean, re-ranked, into <out>; the seed
    files are deleted unless --keep_seed_ranks;
  * --export_scores: the sigmoid-mean of the per-seed score tensors;
  * --triples: the sigmoid-mean of the per-seed triple scores
    (probabilities; one checkpoint answers raw scores).
--ablation runs the study on the first checkpoint.

Usage:
  python -m madrigal_tpu_torch.cli.predict --checkpoint model.pt \\
      --synthetic --export_ranks ranks.npy --triples 0:1:2 3:4:5
  python -m madrigal_tpu_torch.cli.predict --checkpoint s1.pt s2.pt \\
      --synthetic --export_ranks ensemble_ranks.npy
  (add --platform cpu to run without a card)
  torchrun --nproc_per_node=4 -m madrigal_tpu_torch.cli.predict \
      --sharded --checkpoint model.pt --synthetic --export_ranks ranks.npy

--sharded label-shards the rank export over every rank of the process
group (`parallel/allpairs.sharded_rank_tensor`): each rank ranks its
outcomes, and rank 0 gathers them and writes every output file. Under
torchrun the group is torchrun's; run alone it is a one-rank group.
`--backend` picks the group's backend (nccl on the card, gloo under
--platform cpu, or gloo for ranks that share one card).
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from .common import add_common_args, load_data, setup_platform


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Madrigal-TPU prediction "
                                            "(PyTorch port)")
    add_common_args(p)
    p.add_argument("--checkpoint", type=str, required=True, nargs="+",
                   help="checkpoint path(s); >1 runs the multi-seed "
                        "ensemble protocol (gmean of normalized ranks + "
                        "re-rank; sigmoid-mean for scores/triples)")
    p.add_argument("--export_embeddings", type=str, default=None)
    p.add_argument("--export_scores", type=str, default=None,
                   help="write the [L, N, N] raw-score tensor (np.memmap);"
                        " with >1 checkpoints: the sigmoid-mean ensemble")
    p.add_argument("--export_ranks", type=str, default=None,
                   help="write the [L, N, N] normalized-rank tensor; with "
                        ">1 checkpoints: gmean-of-ranks + re-rank")
    p.add_argument("--keep_seed_ranks", action="store_true",
                   help="keep the per-seed <out>.seedK.npy rank tensors "
                        "instead of deleting them after ensembling")
    p.add_argument("--triples", type=str, nargs="*", default=[],
                   metavar="L:A:B", help="outcome:drugA:drugB queries")
    p.add_argument("--label_chunk", type=int, default=32)
    p.add_argument("--eval_type", type=str, default=None,
                   help="modality eval type for embeddings, e.g. str_full, "
                        "str+tx_full (head side applies to all drugs)")
    p.add_argument("--finetune_mode", type=str,
                   default="str_random_sample")
    p.add_argument("--sharded", action="store_true",
                   help="label-shard the rank tensor over every rank of "
                        "the process group (torchrun's, or one rank)")
    p.add_argument("--backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="--sharded: the process group's backend (default "
                        "nccl on cuda, gloo on cpu)")
    p.add_argument("--ablation", type=str, default=None, metavar="OUT_JSON",
                   help="run the modality-ablation study (fig2 protocol: "
                        "force-mask modality subsets for full-modality "
                        "drugs, per-label metrics per subset) and write "
                        "the table as JSON")
    p.add_argument("--ablation_combos", type=str, default=None,
                   help="semicolon-separated '+'-joined modality subsets "
                        "for --ablation, e.g. 'str;str+kg;str+kg+cv+tx' "
                        "(default: all 15 non-empty subsets)")
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


def _memmap(path: str, shape) -> np.ndarray:
    return np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                     shape=shape)


def _join_group(args) -> None:
    """--sharded: join torchrun's process group, or make a one-rank one,
    binding this rank's card before anything is allocated."""
    from ..parallel.dryrun import free_port
    from ..parallel.multihost import initialize

    if "RANK" in os.environ:
        initialize(device=args.platform, backend=args.backend)
    else:
        initialize(f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                   device=args.platform, backend=args.backend)


def _rank_tensor_into(z, w, out, args, device):
    """The [L, N, N] ranks of one checkpoint into `out` (rank 0's with
    --sharded; None elsewhere)."""
    from ..eval.ranks import rank_tensor

    if args.sharded:
        from ..parallel.allpairs import sharded_rank_tensor
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(("label",))
        per_rank = max(1, args.label_chunk // mesh.size())
        return sharded_rank_tensor(mesh, z, w.cpu().numpy(),
                                   chunk_per_device=per_rank, out=out)
    return rank_tensor(z, w, chunk=args.label_chunk, out=out, device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.sharded:
        _join_group(args)
        import torch.distributed as dist

        writer = dist.get_rank() == 0
    else:
        writer = True
    try:
        res = _main(args, writer)
        if args.sharded:  # every rank is done before the files are read
            from ..parallel.multihost import sync_hosts

            sync_hosts("predict")
        return res
    finally:
        if args.sharded:
            from ..parallel.multihost import shutdown

            shutdown()


def _main(args, writer: bool):
    """The CLI's work; only the `writer` rank writes files and logs."""
    device = setup_platform(args)

    from ..eval.predict import (
        decoder_weight,
        embed_all_drugs,
        ensemble_sigmoid_mean,
        ensemble_sigmoid_scores_all_pairs,
        model_from_checkpoint,
        score_all_pairs,
        score_triples_for_pairs,
    )
    from ..eval.ranks import ensemble_normalized_ranks

    logger = _logger()
    if not writer:
        logger.setLevel(logging.WARNING)
    ds, coll = load_data(args, device)
    models = [model_from_checkpoint(path, device=device)[0]
              for path in args.checkpoint]
    kg = coll.kg_batch()

    eval_masks = None
    if args.eval_type:
        from ..eval.masks import get_evaluate_masks

        base = np.asarray(ds.masks)
        eval_masks, _ = get_evaluate_masks(base, base, args.eval_type,
                                           args.finetune_mode)
    zs = []
    for model, path in zip(models, args.checkpoint):
        z = embed_all_drugs(model, coll, kg, eval_masks=eval_masks)
        zs.append(z)
        logger.info(f"embedded {z.shape[0]} drugs -> {z.shape} on {device}"
                    f" ({path})")
    multi = len(models) > 1
    if args.export_embeddings and writer:
        np.save(args.export_embeddings, np.stack(zs) if multi else zs[0])
        logger.info(f"wrote {args.export_embeddings}"
                    + (f" ({len(zs)} seeds stacked)" if multi else ""))

    L = models[0].decoder.weight.shape[0]
    n = zs[0].shape[0]

    if args.export_scores and writer:
        out = _memmap(args.export_scores, (L, n, n))
        if multi:
            ensemble_sigmoid_scores_all_pairs(
                list(zip(models, zs)), label_chunk=args.label_chunk, out=out)
        else:
            score_all_pairs(models[0], zs[0], label_chunk=args.label_chunk,
                            out=out)
        out.flush()
        logger.info(f"wrote {args.export_scores}"
                    + (" (sigmoid-mean ensemble)" if multi else ""))

    if args.export_ranks:
        out = _memmap(args.export_ranks, (L, n, n)) if writer else None
        if multi:
            seed_paths, seed_maps = [], []
            for i, (model, z) in enumerate(zip(models, zs)):
                sp = f"{args.export_ranks}.seed{i}.npy"
                sout = _memmap(sp, (L, n, n)) if writer else None
                _rank_tensor_into(z, decoder_weight(model), sout, args,
                                  device)
                if writer:
                    sout.flush()
                    seed_paths.append(sp)
                    seed_maps.append(np.load(sp, mmap_mode="r"))
                    logger.info(f"seed {i} rank tensor -> {sp}")
            if writer:
                ensemble_normalized_ranks(seed_maps, out=out,
                                          chunk=args.label_chunk,
                                          device=device)
                if not args.keep_seed_ranks:
                    del seed_maps
                    for sp in seed_paths:
                        os.remove(sp)
        else:
            _rank_tensor_into(zs[0], decoder_weight(models[0]), out, args,
                              device)
        if writer:
            out.flush()
            logger.info(f"wrote {args.export_ranks}"
                        + (" (gmean-of-ranks ensemble, re-ranked)"
                           if multi else "")
                        + (" (label-sharded)" if args.sharded else ""))

    if args.ablation and writer:
        from ..eval.ablation import modality_ablation_study

        # the full-KG batch above serves the study too
        batch, _ = coll(build_kg=False)
        combos = ([tuple(c.split("+"))
                   for c in args.ablation_combos.split(";")]
                  if args.ablation_combos else None)
        table = modality_ablation_study(models[0], batch, kg,
                                        args.finetune_mode, combos=combos)
        serializable = {
            combo: {k: np.asarray(v, np.float64).tolist()
                    for k, v in row.items()}
            for combo, row in table.items()
        }
        with open(args.ablation, "w") as f:
            json.dump(serializable, f, indent=1)
        logger.info(f"wrote modality-ablation table ({len(table)} subsets)"
                    f" -> {args.ablation}")

    if args.triples:
        triples = [tuple(int(x) for x in t.split(":")) for t in args.triples]
        per_seed = [score_triples_for_pairs(model, z, triples)
                    for model, z in zip(models, zs)]
        if multi:
            scores = ensemble_sigmoid_mean(per_seed)  # probabilities
        else:
            scores = per_seed[0]  # raw scores (single-seed behavior)
        for t, s in zip(triples, scores):
            logger.info(f"outcome={t[0]} drugA={t[1]} drugB={t[2]} "
                        f"{'prob' if multi else 'score'}={float(s):.4f}")
        return scores
    return np.stack(zs) if multi else zs[0]


if __name__ == "__main__":
    main()
