"""Classification metrics suite (port of `madrigal_tpu/eval/metrics.py`).

Host-side numpy port of the reference metrics engine
(reference: madrigal/evaluate/metrics.py:23-191): fmax, MCC, AUROC, AUPRC,
NPV, specificity, F1, recall/precision/ap@k, accuracy (+ Cohen's kappa for
multiclass), with macro / weighted / micro / per-label averaging over the
label-grouped samples.

The JAX package takes six functions from scikit-learn, which the card's
machine does not have. Here they are numpy functions of the same names
with scikit-learn's semantics (its 1.9 release) for the inputs this module
gives them: binary 0/1 truths, no sample weights, scores of any float
type. The rest of the module is the JAX package's code as it stands.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

KEY_METRIC = "auprc"
AVERAGE = "macro"
K = 50


# ------------------------------------------- scikit-learn's semantics
def _binary_clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, scores descending:
    tied scores form one threshold (sklearn's
    confusion_matrix_at_thresholds)."""
    y_true = (np.asarray(y_true).ravel() == 1).astype(np.float64)
    y_score = np.asarray(y_score).ravel()
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    y_true = y_true[order]
    distinct = np.nonzero(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds): thresholds ascending, and the
    curve ends at the point (precision 1, recall 0)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(ps != 0, tps / ps, 0.0)
    if tps[-1] == 0:
        recall = np.full(tps.shape, 1.0)
    else:
        recall = tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), thresholds[::-1])


def average_precision_score(y_true, y_score) -> float:
    """The step sum of precision over recall increments at the distinct
    thresholds, with no interpolation."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve by the trapezoid rule over the distinct
    thresholds (sklearn drops the points collinear with their neighbours
    first, as here); nan with one class."""
    if len(np.unique(y_true)) != 2:
        return np.nan
    fps, tps, _ = _binary_clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.concatenate([
            [True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
            [True]]))[0]
        fps, tps = fps[keep], tps[keep]
    fpr = np.concatenate([[0.0], fps]) / fps[-1]
    tpr = np.concatenate([[0.0], tps]) / tps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def _label_index(y_true, y_pred, labels):
    """Rows of y_true / y_pred into `labels` (sorted); values outside it
    are dropped."""
    yt = np.asarray(y_true).ravel()
    yp = np.asarray(y_pred).ravel()
    keep = np.isin(yt, labels) & np.isin(yp, labels)
    return (np.searchsorted(labels, yt[keep]),
            np.searchsorted(labels, yp[keep]))


def confusion_matrix(y_true, y_pred, labels=None) -> np.ndarray:
    """Counts [truth, prediction] over `labels` (default: every value in
    either), int64."""
    if labels is None:
        labels = np.unique(np.concatenate([np.ravel(y_true),
                                           np.ravel(y_pred)]))
    labels = np.asarray(labels)
    n = labels.size
    ti, pi = _label_index(y_true, y_pred, labels)
    return np.bincount(ti * n + pi, minlength=n * n).reshape(n, n).astype(
        np.int64)


def matthews_corrcoef(y_true, y_pred) -> float:
    """Matthews correlation over the classes present in either input;
    0.0 where its denominator is 0."""
    C = confusion_matrix(y_true, y_pred)
    t_sum = C.sum(axis=1, dtype=np.float64)
    p_sum = C.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(C, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples ** 2 - np.dot(t_sum, t_sum)
    cov_ypyp_ytyt = cov_ypyp * cov_ytyt
    if cov_ypyp_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ypyp_ytyt))


def cohen_kappa_score(y1, y2) -> float:
    """Unweighted Cohen's kappa over the classes present in either input;
    nan where it is undefined."""
    confusion = confusion_matrix(y1, y2).astype(np.float64)
    n_classes = confusion.shape[0]
    sum0 = np.sum(confusion, axis=0)
    sum1 = np.sum(confusion, axis=1)
    denominator = np.sum(sum0)
    if denominator == 0:
        return np.nan
    expected = np.outer(sum0, sum1) / denominator
    w_mat = np.ones([n_classes, n_classes], dtype=np.float64)
    np.fill_diagonal(w_mat, 0)
    denominator = np.sum(w_mat * expected)
    if denominator == 0:
        return np.nan
    return float(1 - np.sum(w_mat * confusion) / denominator)


# ------------------------------------------- the JAX package's module
def fmax_score(ys, preds, beta: float = 1.0):
    precision, recall, thresholds = precision_recall_curve(ys, preds)
    num = (1 + beta ** 2) * precision * recall
    den = beta ** 2 * precision + recall
    with np.errstate(divide="ignore", invalid="ignore"):
        fbeta = np.divide(num, den, out=np.zeros_like(num), where=den != 0)
    return np.nanmax(fbeta), thresholds[np.argmax(fbeta)]


def precision_recall_at_k(y, preds, k: int):
    order = np.argsort(preds.flatten())[::-1]
    topk_y = y[order][:k]
    topk_p = preds[order][:k]
    recall_k = topk_y.sum() / max(y.sum(), 1)
    precision_k = topk_y.sum() / k
    ap_k = (
        average_precision_score(topk_y, topk_p)
        if topk_y.sum() > 0 else 0.0
    )
    if k > preds.shape[-1]:
        return np.nan, np.nan, np.nan
    return recall_k, precision_k, ap_k


def get_metrics_binary(
    preds, ys, k: Union[int, float], context: Optional[str] = None
) -> Dict[str, float]:
    if isinstance(k, float) and k < 1:
        k = int(k * ys.shape[0])
    rounded = np.round(preds)
    cm = confusion_matrix(ys, rounded, labels=[0, 1])
    tn, fp, fn, tp = cm.ravel()
    with np.errstate(divide="ignore", invalid="ignore"):
        specificity = np.divide(tn, tn + fp) if (tn + fp) else np.nan
        recall = np.divide(tp, tp + fn) if (tp + fn) else np.nan
        npv = np.divide(tn, tn + fn) if (tn + fn) else np.nan
        precision = np.divide(tp, tp + fp) if (tp + fp) else np.nan
        f1 = (
            2 * precision * recall / (precision + recall)
            if (precision + recall) else np.nan
        )
    accuracy = (tp + tn) / max(tn + fn + tp + fp, 1)

    fmax, _ = fmax_score(ys, preds)
    recall_k, precision_k, ap_k = precision_recall_at_k(ys, preds, k)
    two_class = len(np.unique(ys)) == 2
    auroc = roc_auc_score(ys, preds) if two_class else np.nan
    auprc = average_precision_score(ys, preds) if ys.sum() else np.nan
    mcc = matthews_corrcoef(ys, rounded)

    out = {
        "fmax": fmax,
        "mcc": mcc,
        "auroc": auroc,
        "auprc": auprc,
        "npv": npv,
        "specificity": specificity,
        "f1": f1,
        f"recall@{k}": recall_k,
        f"precision@{k}": precision_k,
        f"ap@{k}": ap_k,
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
    }
    if context == "multiclass":
        out["cohen_kappa"] = cohen_kappa_score(ys, rounded)
    return out


def get_metrics(
    preds: np.ndarray,
    ys: np.ndarray,
    labels: np.ndarray,
    k: Union[int, float] = K,
    task: str = "multilabel",
    average: Optional[str] = AVERAGE,
    logger: Any = None,
    verbose: bool = False,
) -> Tuple[Dict[str, Union[float, np.ndarray]], np.ndarray]:
    """Metrics per label group, averaged (reference metrics.py:129-191)."""
    preds, ys, labels = map(np.asarray, (preds, ys, labels))
    if task == "binary":
        return get_metrics_binary(preds, ys, k), np.asarray(ys.sum())

    idx_sort = np.argsort(labels, kind="stable")
    sorted_labels = labels[idx_sort]
    vals, idx_start, counts = np.unique(
        sorted_labels, return_index=True, return_counts=True
    )
    groups = np.split(idx_sort, idx_start[1:])
    pos_samples = np.array([ys[g].sum() for g in groups])

    if average == "micro":
        metrics = get_metrics_binary(preds, ys, k)
    else:
        rows = [get_metrics_binary(preds[g], ys[g], k) for g in groups]
        names = list(rows[0].keys())
        arr = np.array([[r[n] for n in names] for r in rows])
        if average == "macro":
            import warnings

            with np.errstate(invalid="ignore"), warnings.catch_warnings():
                # all-NaN metric columns (e.g. @k with k > group size)
                # legitimately average to NaN
                warnings.simplefilter("ignore", RuntimeWarning)
                vals_avg = np.nanmean(arr, axis=0)
            metrics = dict(zip(names, vals_avg))
        elif average == "weighted":
            w = pos_samples / max(pos_samples.sum(), 1)
            metrics = dict(zip(names, np.nansum(arr * w[:, None], axis=0)))
        elif average is None:
            metrics = dict(zip(names, arr.T))
        else:
            raise ValueError(average)

    if verbose and average is not None:
        msg = ", ".join(f"{k_} = {v:.4f}" for k_, v in metrics.items())
        (logger.info if logger else print)(msg)
    return metrics, pos_samples
