"""chemCPA tx-adaptation sweep entry point (port of
`madrigal_tpu/cli/chemcpa_sweep.py`; reference modality_pretraining/tx/
sweep.py): read a seml-format sweep file (fixed/grid/random blocks,
configs/chemcpa/chemcpa_tx_adapting_configs_sweep.yaml layout), expand it
into concrete configs, train each with early stopping and the NaN stops,
write a sweep-summary JSONL, and save the best config's chemCPA model.

  python -m madrigal_tpu_torch.cli.chemcpa_sweep --sweep_yaml sweep.json \\
      --synthetic --save_dir sweep [--max_configs 4] [--epoch_cap 20] \\
      [--holdout 0.2]
  (add --platform cpu to run without a card)

It takes the JAX CLI's flags: `--sweep_yaml` reads a `.json` file with
the `json` module and a `.yaml` one with pyyaml (`utils/config_gen.py`
says how to write floats that both readers take). The tx rows, the
availability filter and the holdout split are the JAX CLI's; like it,
`--synthetic_scale` is ignored and `--synthetic` builds
`make_dataset(--synthetic_drugs, ...)`. The best encoder is written to
`{save_dir}/tx_pretrained_best` as the port's stage-1 tx run writes
`tx_pretrained` (the chemCPA state_dict under `tx_encoder.`), so
`cli.pretrain --modality_ckpts` and `train/transfer.
overlay_stage1_checkpoint` take it. `main` returns the sweep's result
with `checkpoint` (that path, or None when no config gave a finite R2).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .common import add_common_args, setup_platform, tx_rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Madrigal-TPU chemCPA sweep (PyTorch port)")
    add_common_args(p)
    p.add_argument("--sweep_yaml", type=str, required=True,
                   help="seml-format sweep config (fixed/grid/random "
                        "blocks), .json or .yaml")
    p.add_argument("--max_configs", type=int, default=None,
                   help="cap the number of expanded configs trained")
    p.add_argument("--epoch_cap", type=int, default=None,
                   help="clamp training.num_epochs (smoke tests)")
    p.add_argument("--holdout", type=float, default=0.2,
                   help="test fraction for the R2 early-stopping metric")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = setup_platform(args)

    from ..config import ChemCPAConfig
    from ..train.checkpoint import save_checkpoint
    from ..train.chemcpa_sweep import run_chemcpa_sweep
    from ..utils.config_gen import generate_configs, read_config
    from ..utils.logging import get_root_logger

    os.makedirs(args.save_dir, exist_ok=True)
    logger = get_root_logger(
        os.path.join(args.save_dir, "chemcpa_sweep.log"))

    _, _, experiment = read_config(args.sweep_yaml)
    configs = generate_configs(experiment, seed=args.seed)
    logger.info(f"expanded {len(configs)} configs from {args.sweep_yaml}")

    if args.synthetic or not args.data_dir:
        from ..data.synthetic import make_dataset

        ds = make_dataset(num_drugs=args.synthetic_drugs,
                          num_labels=args.synthetic_labels,
                          num_edges=args.synthetic_edges, seed=args.seed)
    else:
        from ..data.datasets import load_reference_dataset

        ds = load_reference_dataset(args.data_dir)
    genes, cov = tx_rows(ds)
    rng = np.random.RandomState(args.seed)
    order = rng.permutation(len(genes))
    n_test = max(1, int(len(genes) * args.holdout))
    test_idx, train_idx = order[:n_test], order[n_test:]

    C, _, G = ds.tx_table.shape
    out = run_chemcpa_sweep(
        configs,
        genes[train_idx], cov[train_idx], genes[test_idx], cov[test_idx],
        base_cfg=ChemCPAConfig(num_genes=G, num_covariates=C),
        out_jsonl=os.path.join(args.save_dir, "sweep_results.jsonl"),
        max_configs=args.max_configs,
        epoch_cap=args.epoch_cap,
        logger=logger,
        device=device,
    )
    logger.info(f"best config {out['best_index']}: "
                f"test R2 {out['best_r2']:.4f}")
    out["checkpoint"] = None
    if out["best_variables"] is not None:
        path = os.path.join(args.save_dir, "tx_pretrained_best")
        save_checkpoint(path, {"tx_encoder." + k: v for k, v in
                               out["best_variables"].items()},
                        out["best_config"], epoch=0)
        logger.info(f"saved best encoder to {path}")
        out["checkpoint"] = path
    return out


if __name__ == "__main__":
    main()
