"""Stage-1 per-modality pretraining entry point (port of
`madrigal_tpu/cli/modality_pretrain.py`; reference modality_pretraining/:
str/structure_pretraining_muv.py GIN property prediction,
kg/kg_pretraining.py HGT link prediction with RandomLinkSplit,
cv/cv_pretraining.py the MLP autoencoder, tx/sweep.py chemCPA adaptation):

  python -m madrigal_tpu_torch.cli.modality_pretrain --modality str \\
      --synthetic --num_epochs 20 --save_dir s1
  (add --platform cpu to run without a card)

It takes the JAX CLI's flags and draws the same host numbers from
`RandomState(--seed)` in the same order (labels and masks for str, the
link split for kg, the minibatch order for tx), and writes
`{save_dir}/{modality}_pretrained`: a port checkpoint whose state_dict
holds the trained encoder under `{modality}_encoder.` (tx: the whole
chemCPA model, decoder included), which `cli.pretrain --modality_ckpts`
overlays on the stage-2 encoder (`train/transfer.py`). `main` returns
that path.

Two differences from the JAX CLI:
  * kg builds the source-sorted KG layout of the message edges unless
    `--no_src_mxu`, so that the HGT's source-gather backward runs on
    kernel K2, as the port's other training CLIs do (the JAX CLI builds
    the plain layout; the results are the same).
  * `--set` and `--from_yaml` raise: every stage-1 setting is a flag of
    this CLI. The JAX CLI parses both and ignores them.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .common import add_common_args, load_data, setup_platform, tx_rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Madrigal-TPU stage-1 modality pretraining "
                    "(PyTorch port)")
    add_common_args(p)
    p.add_argument("--modality", type=str, required=True,
                   choices=["str", "kg", "cv", "tx"])
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--feature_dim", type=int, default=128)
    # str (GIN property prediction; MUV has 17 tasks)
    p.add_argument("--num_tasks", type=int, default=17)
    p.add_argument("--gin_hidden_dims", type=int, nargs="+",
                   default=[128, 128, 128])
    p.add_argument("--gin_num_mlp_layer", type=int, default=3)
    # kg (HGT link prediction)
    p.add_argument("--hgt_hidden_dim", type=int, default=128)
    p.add_argument("--hgt_num_layers", type=int, default=2)
    p.add_argument("--hgt_att_heads", type=int, default=4)
    p.add_argument("--neg_ratio", type=float, default=2.0)
    # cv (tabular autoencoder)
    p.add_argument("--cv_hidden_dims", type=int, nargs="+",
                   default=[512, 256])
    # tx (chemCPA adaptation)
    p.add_argument("--tx_width", type=int, default=512)
    p.add_argument("--tx_depth", type=int, default=2)
    p.add_argument("--tx_batch_size", type=int, default=128)
    p.add_argument("--disable_adv", action="store_true", default=True)
    p.add_argument("--enable_adv", dest="disable_adv", action="store_false")
    p.add_argument("--eval_disentanglement", action="store_true",
                   help="run the latent-basal disentanglement probe after "
                        "tx training (reference train.py:462)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    if args.set or args.from_yaml:
        raise ValueError("--set and --from_yaml: every stage-1 setting is "
                         "a flag of this CLI")
    device = setup_platform(args)

    from ..config import ChemCPAConfig, GINConfig, HGTConfig, MLPEncoderConfig
    from ..constants import CV_INPUT_DIM, NUM_CELL_LINES, TX_INPUT_DIM
    from ..data.kg import build_kg_batch, kg_schema
    from ..train.checkpoint import check_finite_loss, save_checkpoint
    from ..train.modality_pretrain import (
        ChemCPAAdaptTrainer,
        GINPretrainer,
        HGTLinkPredTrainer,
        TabularAETrainer,
        evaluate_disentanglement,
        evaluate_r2_tx_adapting,
    )
    from ..utils.logging import MetricLogger, get_root_logger

    os.makedirs(args.save_dir, exist_ok=True)
    logger = get_root_logger(
        os.path.join(args.save_dir, f"pretrain_{args.modality}.log"))
    mlog = MetricLogger(args.save_dir, run_name=f"pretrain_{args.modality}")

    ds, coll = load_data(args, device)
    rng = np.random.RandomState(args.seed)
    path = os.path.join(args.save_dir, f"{args.modality}_pretrained")
    key = f"{args.modality}_encoder."

    if args.modality == "str":
        # property-prediction pretraining (the MUV analog); on synthetic
        # data, per-drug binary property labels stand in for MUV's assays
        cfg = GINConfig(hidden_dims=tuple(args.gin_hidden_dims),
                        num_mlp_layer=args.gin_num_mlp_layer)
        trainer = GINPretrainer(cfg, feature_dim=args.feature_dim,
                                num_tasks=args.num_tasks, lr=args.lr,
                                seed=args.seed, device=device)
        batch = coll.drug_batch(np.arange(ds.num_drugs)).mols
        labels = (rng.rand(ds.num_drugs, args.num_tasks) < 0.3
                  ).astype(np.float32)
        mask = (rng.rand(ds.num_drugs, args.num_tasks) < 0.9
                ).astype(np.float32)
        for epoch in range(args.num_epochs):
            loss = check_finite_loss(
                trainer.train_step(batch, labels, mask), "str")
            mlog.log({"str_loss": loss}, step=epoch)
        sd = trainer.encoder_params()

    elif args.modality == "kg":
        cfg = HGTConfig(hidden_dim=args.hgt_hidden_dim,
                        num_layers=args.hgt_num_layers,
                        att_heads=args.hgt_att_heads)
        num_nodes = {nt: v.shape[0] for nt, v in ds.kg_node_feats.items()}
        queries, labels, message_edges = HGTLinkPredTrainer.make_link_split(
            ds.kg_edge_indices, rng, num_nodes, neg_ratio=args.neg_ratio)
        kg = build_kg_batch(ds.kg_node_feats, message_edges,
                            ds.kg_drug_ids, device=device,
                            src_sort=not args.no_src_mxu)
        trainer = HGTLinkPredTrainer(
            cfg, args.feature_dim, *kg_schema(ds.kg_node_feats,
                                              message_edges),
            lr=args.lr, seed=args.seed, device=device)
        queries = trainer.queries_to_device(queries)
        labels = torch.as_tensor(labels, device=device)
        logger.info(f"kg link split: {len(labels)} queries, "
                    f"{sum(e.shape[1] for e in message_edges.values())} "
                    "message edges")
        for epoch in range(args.num_epochs):
            loss = check_finite_loss(
                trainer.train_step(kg, queries, labels), "kg")
            mlog.log({"kg_loss": loss}, step=epoch)
        sd = trainer.encoder_params()

    elif args.modality == "cv":
        cfg = MLPEncoderConfig(hidden_dims=tuple(args.cv_hidden_dims))
        trainer = TabularAETrainer(
            input_dim=CV_INPUT_DIM, hidden_dims=tuple(args.cv_hidden_dims),
            latent_dim=args.feature_dim, lr=args.lr, seed=args.seed,
            device=device)
        avail = ds.mod_avail[:, 2] == 1
        x = torch.as_tensor(ds.cv_table[avail] if avail.any()
                            else ds.cv_table, device=device)
        for epoch in range(args.num_epochs):
            loss = check_finite_loss(trainer.train_step(x), "cv")
            mlog.log({"cv_loss": loss}, step=epoch)
        sd = trainer.encoder_params()

    else:  # tx
        cfg = ChemCPAConfig(
            num_genes=TX_INPUT_DIM, dim=args.feature_dim,
            autoencoder_width=args.tx_width,
            autoencoder_depth=args.tx_depth,
            num_covariates=NUM_CELL_LINES,
            disable_adv=args.disable_adv,
        )
        trainer = ChemCPAAdaptTrainer(cfg, lr=args.lr, seed=args.seed,
                                      device=device)
        # (genes, cell-line) rows for the drug-free adaptation objective
        # (the Madrigal tx stage)
        genes_all, cov_all = tx_rows(ds)
        bs = min(args.tx_batch_size, len(genes_all))
        genes_dev = torch.as_tensor(genes_all, device=device)
        cov_dev = torch.as_tensor(cov_all, device=device)
        for epoch in range(args.num_epochs):
            order = torch.as_tensor(rng.permutation(len(genes_all))[:bs],
                                    device=device)
            out = trainer.train_step(genes_dev[order], cov_dev[order])
            mlog.log(out, step=epoch)
            check_finite_loss(out, "tx")
        r2 = evaluate_r2_tx_adapting(trainer, genes_all[:512], cov_all[:512])
        logger.info(f"tx adaptation R2: {r2:.4f}")
        mlog.log({"tx_r2": r2})
        if args.eval_disentanglement:
            dis = evaluate_disentanglement(
                trainer, genes_all[:512], {"covariate": cov_all[:512]},
                epochs=150)
            logger.info(f"tx disentanglement: {dis}")
            mlog.log({f"tx_disent_{k}": v for k, v in dis.items()})
        sd = trainer.encoder_variables()

    save_checkpoint(path, {key + k: v for k, v in sd.items()}, cfg,
                    epoch=args.num_epochs)
    logger.info(f"saved {args.modality} encoder to {path}")
    mlog.finish()
    return path


if __name__ == "__main__":
    main()
