"""Analysis entry point: queries over exported score / rank tensors
(port of `madrigal_tpu/cli/analyze.py`: the same flags and the same JSON
on standard output).

CLI surface for the analysis layer (`analysis/ddi_queries.py`) — the
computational core of the reference's figure notebooks run end-to-end on
the artifacts `cli/predict.py` exports, without writing Python
(reference: notebooks/quick_predictions.ipynb cell 8 pair lookups into
the 80 GB rank tensor; fig3/fig3_self_combo.ipynb self-combo diagonals +
mannwhitneyu enrichment; fig4/fig4_clinical_trials_combos.ipynb
candidate-set enrichment vs background; fig5/fig5_t2d_mash.ipynb
outcome-subset aggregation via notebooks/outcome_mapper.json).

Tensors are `.npy` files opened with mmap, indexed one outcome slice at
a time — the full-scale [960, 6843, 6843] artifacts never load resident.
Every query is numpy and scipy on the host, in this package as in the
JAX one: no device is touched, so there is no `--platform` flag (and no
CPU fallback behind one).

Examples:
  python -m madrigal_tpu_torch.cli.analyze --tensor ranks.npy \\
      --pairs 12:44 3:9 --labels 0,5       # pair lookups (JSON out)
  python -m madrigal_tpu_torch.cli.analyze --tensor ranks.npy --label 5 \\
      --topk 20 --known known_ddis.npy     # novel-pair table
  python -m madrigal_tpu_torch.cli.analyze --tensor ranks.npy --label 5 \\
      --enrich candidates.csv              # Mann-Whitney vs background
  python -m madrigal_tpu_torch.cli.analyze --tensor ranks.npy \\
      --aggregate gmean --labels 3,7,11 --out agg.npy
  python -m madrigal_tpu_torch.cli.analyze --tensor scores.npy \\
      --self_combo sc.npy
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..analysis import (
    aggregate_outcomes,
    cv_validation_auroc,
    external_validation,
    load_outcome_mapper,
    map_outcome_labels,
    pair_values,
    rank_enrichment,
    self_combo_scores,
    topk_novel_pairs,
)


def _parse_pairs(items):
    """'A:B' pair strings -> [P, 2] int array."""
    out = []
    for it in items:
        a, b = it.split(":")
        out.append((int(a), int(b)))
    return out


def _load_pairs_file(path: str):
    """Two-column csv/tsv/whitespace drug-index pairs (no header)."""
    return np.loadtxt(path, dtype=np.int64, delimiter=None,
                      converters=None, ndmin=2)[:, :2]


def _resolve_labels(args, L: int):
    """--labels '0,5,9' and/or --outcome+--outcome_mapper -> label list."""
    if args.outcome:
        if not (args.outcome_mapper and args.label_names):
            raise SystemExit("--outcome needs --outcome_mapper and "
                             "--label_names")
        mapper = load_outcome_mapper(args.outcome_mapper)
        with open(args.label_names) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        labels = map_outcome_labels(mapper, args.outcome, args.dataset,
                                    names)
        if not labels:
            raise SystemExit(f"outcome {args.outcome!r} maps to no labels "
                             f"of dataset {args.dataset!r}")
        return labels
    if args.labels:
        return [int(x) for x in args.labels.split(",")]
    return list(range(L))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="queries over exported [L, N, N] score/rank tensors")
    p.add_argument("--tensor", type=str, required=True,
                   help=".npy score or normalized-rank tensor "
                        "(cli.predict --export_scores/--export_ranks)")
    p.add_argument("--labels", type=str, default=None,
                   help="comma-separated outcome indices (default: all)")
    p.add_argument("--label", type=int, default=None,
                   help="single outcome index (topk/enrich)")
    p.add_argument("--outcome", type=str, default=None,
                   help="canonical outcome name resolved through the "
                        "outcome mapper (instead of --labels)")
    p.add_argument("--outcome_mapper", type=str, default=None,
                   help="outcome_mapper.json path")
    p.add_argument("--dataset", type=str, default="twosides")
    p.add_argument("--label_names", type=str, default=None,
                   help="text file: one label name per tensor label row")
    # queries
    p.add_argument("--pairs", nargs="*", default=None, metavar="A:B",
                   help="drug-index pair lookups")
    p.add_argument("--self_combo", type=str, default=None, metavar="OUT",
                   help="write the [L, N] self-combination diagonal")
    p.add_argument("--topk", type=int, default=None,
                   help="top-k pair table for --label (or the --aggregate "
                        "matrix when one is requested)")
    p.add_argument("--smallest", action="store_true",
                   help="topk: smallest values instead of largest")
    p.add_argument("--known", type=str, default=None,
                   help=".npy [N, N] bool known-interaction mask excluded "
                        "from --topk (novel-prediction tables)")
    p.add_argument("--enrich", type=str, default=None, metavar="PAIRS_CSV",
                   help="candidate pair file; Mann-Whitney U vs background")
    p.add_argument("--background", type=str, default=None,
                   help="explicit background pair file for --enrich "
                        "(default: all other lower-triangle pairs)")
    p.add_argument("--alternative", type=str, default="greater",
                   choices=["greater", "less", "two-sided"])
    p.add_argument("--aggregate", type=str, default=None,
                   choices=["gmean", "mean", "max"],
                   help="collapse the selected labels to one [N, N] matrix")
    p.add_argument("--out", type=str, default=None,
                   help="output .npy for --aggregate")
    p.add_argument("--validate", type=str, default=None, metavar="CSV",
                   help="external-validation file: rows 'A B target'; "
                        "binary targets -> AUROC/AUPRC, continuous -> "
                        "spearman/kendall vs the --label (or --aggregate) "
                        "matrix values (fig6 protocol)")
    p.add_argument("--cv_auroc", action="store_true",
                   help="with --validate + binary targets: 5-fold CV "
                        "AUROC of an L2 logistic model over the selected "
                        "labels' values as per-pair features "
                        "(fig6_clinical_validation_dfci protocol)")
    args = p.parse_args(argv)

    tensor = np.load(args.tensor, mmap_mode="r")
    if tensor.ndim != 3 or tensor.shape[1] != tensor.shape[2]:
        raise SystemExit(f"expected [L, N, N] tensor, got {tensor.shape}")
    L, n = tensor.shape[0], tensor.shape[1]
    result = {"tensor": args.tensor, "shape": list(tensor.shape)}

    if args.self_combo:
        sc = self_combo_scores(tensor)
        np.save(args.self_combo, sc)
        result["self_combo"] = {"path": args.self_combo,
                                "shape": list(sc.shape)}

    if args.pairs:
        labels = _resolve_labels(args, L)
        vals = pair_values(tensor, _parse_pairs(args.pairs), labels)
        result["pairs"] = {
            "labels": labels,
            "pairs": args.pairs,
            "values": [[float(v) for v in row] for row in vals],
        }

    agg_mat = None
    if args.aggregate:
        labels = _resolve_labels(args, L)
        agg_mat = aggregate_outcomes(tensor, labels, agg=args.aggregate)
        result["aggregate"] = {"agg": args.aggregate, "labels": labels}
        if args.out:
            np.save(args.out, agg_mat.astype(np.float32))
            result["aggregate"]["path"] = args.out

    if args.enrich is not None or args.topk is not None:
        if agg_mat is not None:
            mat, mat_label = agg_mat, f"aggregate:{args.aggregate}"
        else:
            if args.label is None:
                raise SystemExit("--topk/--enrich need --label "
                                 "(or --aggregate)")
            mat, mat_label = np.asarray(tensor[args.label]), args.label
        if args.topk is not None:
            known = (np.load(args.known, mmap_mode="r")
                     if args.known else None)
            pairs, vals = topk_novel_pairs(mat, args.topk, known,
                                           largest=not args.smallest)
            result["topk"] = {
                "label": mat_label,
                "pairs": [[int(a), int(b)] for a, b in pairs],
                "values": [float(v) for v in vals],
            }
        if args.enrich is not None:
            cand = _load_pairs_file(args.enrich)
            bg = (_load_pairs_file(args.background)
                  if args.background else None)
            res = rank_enrichment(mat, cand, bg,
                                  alternative=args.alternative)
            result["enrichment"] = {
                "label": mat_label,
                "n_candidates": int(len(cand)),
                "statistic": float(res.statistic),
                "pvalue": float(res.pvalue),
                "alternative": args.alternative,
            }

    if args.validate is not None:
        rows = np.loadtxt(args.validate, dtype=np.float64, ndmin=2)
        if rows.shape[1] < 3:
            raise SystemExit("--validate rows need 3 columns: A B target")
        vpairs = rows[:, :2].astype(np.int64)
        targets = rows[:, 2]
        if args.cv_auroc:
            labels = _resolve_labels(args, L)
            feats = pair_values(tensor, vpairs, labels).T  # [P, L']
            result["cv_auroc"] = {"labels": labels,
                                  **cv_validation_auroc(feats, targets)}
        else:
            if agg_mat is not None:
                mat, mat_label = agg_mat, f"aggregate:{args.aggregate}"
            elif args.label is not None:
                mat, mat_label = np.asarray(tensor[args.label]), args.label
            else:
                raise SystemExit("--validate needs --label (or --aggregate,"
                                 " or --cv_auroc over --labels)")
            a = np.maximum(vpairs[:, 0], vpairs[:, 1])
            b = np.minimum(vpairs[:, 0], vpairs[:, 1])
            result["validation"] = {
                "label": mat_label,
                **external_validation(mat[a, b], targets),
            }

    json.dump(result, sys.stdout, indent=1)
    print()


if __name__ == "__main__":
    main()
