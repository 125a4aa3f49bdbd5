"""Queries + statistics over [L, N, N] score / normalized-rank tensors
(port of `madrigal_tpu/analysis/ddi_queries.py`, a copy but for
scikit-learn: the card's machine has none).

The reusable computational core of the reference's analysis notebooks
(reference: notebooks/fig3/fig3_self_combo.ipynb self-combo diagonals +
mannwhitneyu enrichment; fig4/fig4_clinical_trials_combos.ipynb
candidate-pair rank lookups vs background; fig5/fig5_t2d_mash.ipynb
outcome-subset aggregation; notebooks/outcome_mapper.json canonical
outcome -> per-dataset label-name lists). Everything is numpy/scipy and
np.memmap-friendly: tensors are indexed one outcome slice at a time, so
the reference's 80 GB artifacts never need to be resident.

Where the JAX package calls scikit-learn, this module uses the port's
`eval/metrics.{roc_auc_score, average_precision_score}` (held to
scikit-learn within 1e-12) and `fit_logistic_l2`, scikit-learn's L2
logistic regression objective fitted in float64 with scipy's L-BFGS-B.
scikit-learn stops at its own tolerance, so the two fits differ slightly
(the tests state by how much); the folds and the alpha choice are the
JAX package's.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def self_combo_scores(tensor) -> np.ndarray:
    """[L, N] self-combination diagonal (fig3_self_combo.ipynb:
    raw_scores[:, arange(N), arange(N)]), streamed per outcome."""
    L, n, _ = tensor.shape
    out = np.empty((L, n), dtype=np.asarray(tensor[0, 0, :1]).dtype)
    for l in range(L):
        out[l] = np.diagonal(np.asarray(tensor[l]))
    return out


def pair_values(tensor, pairs: Sequence[Tuple[int, int]],
                labels: Optional[Sequence[int]] = None) -> np.ndarray:
    """[L', P] tensor values for drug pairs.

    Normalized-rank tensors are symmetric with a zero diagonal/upper
    source triangle already symmetrized (eval/ranks.py), so (a, b) and
    (b, a) agree; raw-score tensors from the symmetric bilinear decoder
    are symmetric as well. labels selects an outcome subset (default:
    all L outcomes). Streams one outcome slice at a time.
    """
    pairs = np.asarray(pairs, dtype=np.int64)
    a, b = pairs[:, 0], pairs[:, 1]
    lab = (np.arange(tensor.shape[0]) if labels is None
           else np.asarray(labels, dtype=np.int64))
    out = np.empty((len(lab), len(pairs)), dtype=np.float64)
    for i, l in enumerate(lab):
        sl = np.asarray(tensor[l])
        out[i] = sl[a, b]
    return out


def aggregate_outcomes(tensor, labels: Sequence[int],
                       agg: str = "gmean") -> np.ndarray:
    """[N, N] aggregate over an outcome subset (fig5-style: collapse the
    outcome_mapper's label group for one canonical outcome into a single
    pair matrix). agg: 'gmean' (the ensembling convention for normalized
    ranks), 'mean', or 'max'."""
    labels = list(labels)
    if not labels:
        raise ValueError("empty label set")
    if agg == "gmean":
        acc = np.zeros_like(np.asarray(tensor[labels[0]], np.float64))
        with np.errstate(divide="ignore"):
            for l in labels:
                acc += np.log(np.asarray(tensor[l], np.float64))
        return np.exp(acc / len(labels))
    if agg == "mean":
        acc = np.zeros_like(np.asarray(tensor[labels[0]], np.float64))
        for l in labels:
            acc += np.asarray(tensor[l], np.float64)
        return acc / len(labels)
    if agg == "max":
        acc = np.asarray(tensor[labels[0]], np.float64).copy()
        for l in labels[1:]:
            np.maximum(acc, np.asarray(tensor[l], np.float64), out=acc)
        return acc
    raise ValueError(agg)


def topk_novel_pairs(
    mat: np.ndarray,
    k: int,
    known_mask: Optional[np.ndarray] = None,
    largest: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k drug pairs of one [N, N] outcome matrix, strict lower
    triangle only (each unordered pair counted once), optionally
    excluding known interactions (the notebooks' novel-prediction
    tables). Returns (pairs [k, 2] with a > b, values [k])."""
    mat = np.asarray(mat, np.float64)
    n = mat.shape[0]
    tril = np.tri(n, k=-1, dtype=bool)
    valid = tril if known_mask is None else (
        tril & ~(np.asarray(known_mask, bool) |
                 np.asarray(known_mask, bool).T))
    vals = np.where(valid, mat, -np.inf if largest else np.inf)
    flat = vals.ravel()
    k = min(k, int(valid.sum()))
    if largest:
        idx = np.argpartition(-flat, k - 1)[:k]
        idx = idx[np.argsort(-flat[idx], kind="stable")]
    else:
        idx = np.argpartition(flat, k - 1)[:k]
        idx = idx[np.argsort(flat[idx], kind="stable")]
    return np.stack(np.unravel_index(idx, mat.shape), axis=1), flat[idx]


def rank_enrichment(
    mat: np.ndarray,
    candidate_pairs: Sequence[Tuple[int, int]],
    background_pairs: Optional[Sequence[Tuple[int, int]]] = None,
    alternative: str = "greater",
):
    """Mann-Whitney U of candidate-pair values against background pairs
    (fig3/fig4's scipy.stats.mannwhitneyu comparisons, e.g. clinical-
    trial combos vs all other pairs). background defaults to every
    strict-lower-triangle pair not in the candidate set. Returns the
    scipy result object (statistic, pvalue)."""
    from scipy.stats import mannwhitneyu

    mat = np.asarray(mat, np.float64)
    n = mat.shape[0]
    cand = np.asarray(candidate_pairs, np.int64)
    a = np.maximum(cand[:, 0], cand[:, 1])
    b = np.minimum(cand[:, 0], cand[:, 1])
    x = mat[a, b]
    if background_pairs is None:
        sel = np.tri(n, k=-1, dtype=bool)
        sel[a, b] = False
        y = mat[sel]
    else:
        bg = np.asarray(background_pairs, np.int64)
        y = mat[np.maximum(bg[:, 0], bg[:, 1]),
                np.minimum(bg[:, 0], bg[:, 1])]
    return mannwhitneyu(x, y, alternative=alternative)


def external_validation(values: np.ndarray, targets: np.ndarray,
                        kind: str = "auto") -> Dict[str, float]:
    """Predicted pair values vs an external measurement — the fig6
    validation core (reference: notebooks/fig6/fig6_PDX.ipynb cell 56
    spearmanr of predictions vs continuous PDX response,
    fig6_clinical_validation_dfci.ipynb cells 19-43 kendalltau vs
    observed adverse-event proportions + roc_auc_score on binary
    labels).

    kind: 'binary' -> AUROC/AUPRC; 'continuous' -> spearman + kendall
    rank correlations with p-values; 'auto' picks binary when targets
    take exactly the values {0, 1}.
    """
    values = np.asarray(values, np.float64).ravel()
    targets = np.asarray(targets, np.float64).ravel()
    if values.shape != targets.shape:
        raise ValueError(f"{values.shape} values vs {targets.shape} targets")
    keep = np.isfinite(values) & np.isfinite(targets)
    values, targets = values[keep], targets[keep]
    if kind == "auto":
        kind = ("binary" if set(np.unique(targets)) <= {0.0, 1.0}
                else "continuous")
    out: Dict[str, float] = {"kind": kind, "n": int(values.size)}
    if kind == "binary":
        from ..eval.metrics import average_precision_score, roc_auc_score

        two = len(np.unique(targets)) == 2
        out["auroc"] = float(roc_auc_score(targets, values)) if two else float("nan")
        out["auprc"] = (float(average_precision_score(targets, values))
                        if targets.sum() else float("nan"))
        out["prevalence"] = float(targets.mean())
        return out
    from scipy.stats import kendalltau, spearmanr

    sp = spearmanr(values, targets)
    kt = kendalltau(values, targets)
    out["spearman"] = float(sp.statistic)
    out["spearman_pvalue"] = float(sp.pvalue)
    out["kendall"] = float(kt.statistic)
    out["kendall_pvalue"] = float(kt.pvalue)
    return out


def fit_logistic_l2(x: np.ndarray, y: np.ndarray, C: float = 1.0,
                    max_iter: int = 2000) -> Tuple[np.ndarray, float]:
    """(w, b) minimizing scikit-learn's L2 logistic objective
    0.5 * |w|^2 + C * sum_i log(1 + exp(-s_i (w . x_i + b))), s_i = 2 y_i - 1
    (the intercept unpenalized; LogisticRegression(C=C)), in float64 with
    scipy's L-BFGS-B and the exact gradient, to a tighter tolerance than
    scikit-learn's default."""
    from scipy.optimize import minimize
    from scipy.special import expit

    x = np.asarray(x, np.float64)
    s = 2.0 * np.asarray(y, np.float64).ravel() - 1.0
    d = x.shape[1]

    def objective(theta):
        w, b = theta[:d], theta[d]
        m = s * (x @ w + b)
        g = -C * s * expit(-m)  # d loss / d (w . x_i + b)
        return (0.5 * w @ w + C * np.logaddexp(0.0, -m).sum(),
                np.concatenate([w + x.T @ g, [g.sum()]]))

    res = minimize(objective, np.zeros(d + 1), jac=True, method="L-BFGS-B",
                   options={"maxiter": max_iter, "gtol": 1e-10,
                            "ftol": 1e-15})
    return res.x[:d], float(res.x[d])


def cv_validation_auroc(
    features: np.ndarray,
    y: np.ndarray,
    folds: int = 5,
    alphas: Sequence[float] = (1e-3, 1e-2, 1e-1, 1.0, 10.0),
    seed: int = 0,
) -> Dict[str, float]:
    """k-fold CV AUROC of an L2-regularized logistic model over
    per-outcome prediction features (reference:
    fig6_clinical_validation_dfci.ipynb cells 49/54 — features are the
    candidate pairs' predicted values across outcome labels; the
    regularization strength is chosen by mean fold AUROC).

    Returns {'auroc': best mean fold AUROC, 'auroc_std', 'alpha',
    'folds'}. Deterministic shuffled fold assignment from `seed`.
    """
    from ..eval.metrics import roc_auc_score

    x = np.asarray(features, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    y = np.asarray(y, np.float64).ravel()
    if x.shape[0] != y.size:
        raise ValueError(f"{x.shape[0]} feature rows vs {y.size} targets")
    p = x.shape[0]
    folds = min(folds, int(y.sum()), int((1 - y).sum()))
    if folds < 2:
        raise ValueError("need >= 2 positives and negatives for CV folds")
    rng = np.random.RandomState(seed)
    # class-stratified shuffled fold ids (the notebook's StratifiedKFold)
    fold_id = np.empty(p, np.int64)
    for cls in (0, 1):
        idx = np.flatnonzero(y == cls)
        rng.shuffle(idx)
        fold_id[idx] = np.arange(idx.size) % folds
    best = {"auroc": -np.inf}
    for alpha in alphas:
        fold_aurocs = []
        for f in range(folds):
            tr, va = fold_id != f, fold_id == f
            w, b = fit_logistic_l2(x[tr], y[tr], C=1.0 / alpha)
            fold_aurocs.append(roc_auc_score(y[va], x[va] @ w + b))
        mean = float(np.mean(fold_aurocs))
        if mean > best["auroc"]:
            best = {"auroc": mean, "auroc_std": float(np.std(fold_aurocs)),
                    "alpha": float(alpha), "folds": int(folds)}
    return best


def load_outcome_mapper(path: str) -> Dict[str, Dict[str, List[str]]]:
    """notebooks/outcome_mapper.json: canonical outcome ->
    {dataset: [label names]}."""
    with open(path) as f:
        return json.load(f)


def map_outcome_labels(
    mapper: Dict[str, Dict[str, List[str]]],
    outcome: str,
    dataset: str,
    label_names: Sequence[str],
) -> List[int]:
    """Label indices for one canonical outcome under a dataset's label
    vocabulary (case-insensitive exact match, preserving tensor label
    order). Unknown names are skipped -- the notebooks' own behavior
    when a mapped side effect is absent from a dataset."""
    wanted = {s.lower() for s in mapper[outcome].get(dataset.lower(),
                                                     mapper[outcome].get(
                                                         dataset, []))}
    return [i for i, name in enumerate(label_names)
            if str(name).lower() in wanted]
