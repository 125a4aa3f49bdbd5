"""LM-decoder training entry point, zero-shot outcome generalization
(port of `madrigal_tpu/cli/train_lm.py`; reference LM_decoder/
train_ddi_mistral.py): split the DDI table by outcome class, take the
outcome descriptions' language-model embeddings (a file, or embedded
here), train the LMDecoder head on (head, tail, outcome-text) triples
with BCE, and evaluate binary metrics on the held-out (never-trained)
outcome classes each epoch.

  python -m madrigal_tpu_torch.cli.train_lm --synthetic --num_epochs 5 \\
      --save_dir lm_out [--checkpoint best_model] \\
      [--text_embeddings bank.npy] [--drug_embeddings z.npy]
  (add --platform cpu to run without a card)

It takes the JAX CLI's flags. `--checkpoint` is a port checkpoint: the
drug table comes from `eval/predict.model_from_checkpoint` and
`embed_all_drugs` under full masks. `--text_embeddings` is an `.npy`
[L, lm_dim] or paraphrase bank [P, L, lm_dim]; `--descriptions` needs
transformers and local weights. Where the JAX CLI writes the head's
params with orbax, this one writes `{save_dir}/lm_decoder/lm_decoder.pt`
(the head's state_dict; `models/lm_decoder.LMDecoder.from_state_dict`
rebuilds it) beside the JAX CLI's `lm_meta.json`. `main` returns
{best_zero_shot_auroc, losses, metrics (each epoch's zero-shot metrics),
drug_table, eval_table, trainer, path}.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .common import add_common_args, setup_platform


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Madrigal-TPU LM decoder (PyTorch port)")
    add_common_args(p)
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--eval_frac", type=float, default=0.2,
                   help="fraction of outcome classes held out zero-shot")
    p.add_argument("--num_neg_per_pos", type=int, default=1)
    p.add_argument("--project_dim", type=int, default=256)
    p.add_argument("--mlp_dim", type=int, default=512)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--no_self_att", action="store_true")
    p.add_argument("--pos_weight", type=float, default=None,
                   help="enables BCEWithLogits ('bce_with_weight')")
    p.add_argument("--text_embeddings", type=str, default=None,
                   help=".npy [L, lm_dim] or paraphrase bank [P, L, lm_dim]"
                        " of outcome-description embeddings")
    p.add_argument("--lm_model", type=str, default="bert-base-uncased",
                   help="transformers model for on-the-fly description "
                        "embedding (needs local weights)")
    p.add_argument("--descriptions", type=str, default=None,
                   help="text file with one outcome description per line")
    p.add_argument("--drug_embeddings", type=str, default=None,
                   help=".npy [N, D] frozen Madrigal drug embeddings")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="finetune checkpoint; drug embeddings are computed "
                        "with embed_all_drugs under full masks")
    p.add_argument("--lm_dim", type=int, default=64,
                   help="synthetic text-embedding width")
    return p


def _drug_table(args, ds, coll, device) -> np.ndarray:
    if args.drug_embeddings:
        return np.load(args.drug_embeddings)
    if args.checkpoint:
        from ..eval.predict import embed_all_drugs, model_from_checkpoint

        model, _ = model_from_checkpoint(args.checkpoint, device=device)
        return embed_all_drugs(model, coll, coll.kg_batch())
    # synthetic fallback: random table (the head trains against whatever
    # representation it is given; real runs pass --checkpoint)
    rng = np.random.RandomState(args.seed)
    return rng.randn(ds.num_drugs, 128).astype(np.float32)


def _text_table(args, num_labels: int) -> np.ndarray:
    if args.text_embeddings:
        return np.load(args.text_embeddings)
    if args.descriptions:
        from ..models.lm_decoder import extract_text_embeddings

        with open(args.descriptions) as f:
            texts = [line.strip() for line in f if line.strip()]
        if len(texts) != num_labels:
            raise ValueError(
                f"{len(texts)} descriptions for {num_labels} outcomes"
            )
        return extract_text_embeddings(texts, args.lm_model)
    rng = np.random.RandomState(args.seed + 1)
    return rng.randn(num_labels, args.lm_dim).astype(np.float32)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = setup_platform(args)

    from ..train.lm_decoder import (
        LMDecoderTrainer,
        build_lm_table,
        split_by_outcome_classes,
    )
    from ..utils.logging import MetricLogger, get_root_logger
    from .common import load_data

    os.makedirs(args.save_dir, exist_ok=True)
    logger = get_root_logger(os.path.join(args.save_dir, "train_lm.log"))
    mlog = MetricLogger(args.save_dir, run_name="train_lm")

    ds, coll = load_data(args, device)
    train_df, eval_df, train_labels, eval_labels = split_by_outcome_classes(
        ds.edge_df, eval_frac=args.eval_frac, seed=args.seed
    )
    logger.info(
        f"split_by_classes: {len(train_labels)} train outcomes "
        f"({len(train_df)} edges), {len(eval_labels)} zero-shot eval "
        f"outcomes ({len(eval_df)} edges)"
    )
    train_table = build_lm_table(train_df, ds.num_drugs,
                                 args.num_neg_per_pos, seed=args.seed)
    eval_table = build_lm_table(eval_df, ds.num_drugs,
                                args.num_neg_per_pos, seed=args.seed + 7)

    drug_table = _drug_table(args, ds, coll, device)
    trainer = LMDecoderTrainer(
        drug_table=drug_table,
        text_table=_text_table(args, ds.num_labels),
        project_dim=args.project_dim, mlp_dim=args.mlp_dim,
        dropout=args.dropout, self_att=not args.no_self_att,
        lr=args.lr, pos_weight=args.pos_weight, seed=args.seed,
        device=device,
    )

    best_auroc = float("nan")
    losses, history = [], []
    for epoch in range(args.num_epochs):
        loss = trainer.train_epoch(train_table, batch_size=args.batch_size)
        metrics = trainer.evaluate(eval_table)
        losses.append(loss)
        history.append(metrics)
        mlog.log({"lm_loss": loss, **{f"zs_{k}": v
                                      for k, v in metrics.items()}},
                 step=epoch)
        logger.info(
            f"epoch {epoch + 1}/{args.num_epochs}: loss={loss:.4f} "
            f"zero-shot auroc={metrics.get('auroc', float('nan')):.4f}"
        )
        auroc = metrics.get("auroc", float("nan"))
        if not np.isnan(auroc) and (np.isnan(best_auroc)
                                    or auroc > best_auroc):
            best_auroc = auroc

    path = os.path.abspath(os.path.join(args.save_dir, "lm_decoder"))
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in
                trainer.model.state_dict().items()},
               os.path.join(path, "lm_decoder.pt"))
    with open(os.path.join(path, "lm_meta.json"), "w") as f:
        json.dump({
            "eval_labels": [int(x) for x in eval_labels],
            "train_labels": [int(x) for x in train_labels],
            "lm_dim": int(trainer.text_table.shape[-1]),
            "best_zero_shot_auroc": float(best_auroc),
        }, f, indent=2)
    logger.info(f"done; best zero-shot auroc {best_auroc:.4f}")
    mlog.finish()
    return {"best_zero_shot_auroc": best_auroc, "losses": losses,
            "metrics": history, "drug_table": drug_table,
            "eval_table": eval_table, "trainer": trainer, "path": path}


if __name__ == "__main__":
    main()
