"""DDI evaluation engine (port of `madrigal_tpu/eval/evaluate.py`;
reference madrigal/evaluate/evaluate.py:39-247): per-split eval-type
sweeps, direction handling (train: directed for symmetric eval types;
val/test: undirected for asymmetric types; between: always directed),
sigmoid triple scores and the metric suite, and best-metric tracking
keyed per (split, eval_type).

The JAX package's two jitted closures are plain calls here on the port's
`MadrigalMultilabel`, in eval mode and without autograd; the score and
metric CSVs are written with the csv module (the JAX package uses
pandas), with the same columns, order and file names.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.collate import DDIBatch
from ..models.encoder import MadrigalMultilabel
from .masks import MODEL_SELECTION_EVAL_TYPE, get_evaluate_masks
from .metrics import AVERAGE, K, KEY_METRIC, get_metrics
from .predict import eval_mode

SPLIT_EVAL_TYPES = {
    "train": [
        "full_full", "str_str", "str_full", "kg_kg", "cv_cv", "tx_tx",
        "str+kg_full", "str+cv_full", "str+tx_full", "str+cv+tx_full",
        "str+tx_str+tx", "str+cv+tx_str+cv+tx",
    ],
    "val": ["full_full", "str_str", "str+tx_str+tx", "str+cv+tx_str+cv+tx"],
    "test": ["full_full", "str_str", "str+tx_str+tx", "str+cv+tx_str+cv+tx"],
    "between": [
        "full_full", "str_str", "str_full", "kg_kg", "cv_cv", "tx_tx",
        "str+cv_full", "str+tx_full", "str+cv+tx_full",
    ],
    "within": [
        "full_full", "str_str", "kg_kg", "cv_cv", "tx_tx",
        "str+cv_str+cv", "str+tx_str+tx", "str+cv+tx_str+cv+tx",
    ],
}

SYMMETRIC_EVAL_TYPES = {"str_str", "full_full", "kg_kg", "cv_cv", "tx_tx"}


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _direction_arrays(split: str, eval_type: str, batch: DDIBatch):
    """Direction handling (reference evaluate.py:160-189). Returns
    (head_idx, tail_idx, labels, pos_neg, weights) numpy arrays."""
    hi = _np(batch.head_idx)
    ti = _np(batch.tail_idx)
    lb = _np(batch.labels)
    pn = _np(batch.pos_neg)
    m = _np(batch.mask)
    head_g = _np(batch.head.drugs)[hi]
    tail_g = _np(batch.tail.drugs)[ti]

    base = split.split("_")[-1]
    if split == "train" and eval_type in SYMMETRIC_EVAL_TYPES:
        keep = m & (head_g < tail_g)
        return hi, ti, lb, pn, keep
    if base in ("val", "test", "within") and "between" not in split and \
            eval_type.split("_")[0] != eval_type.split("_")[1]:
        # undirect: score both directions. The reference swaps the inverse
        # indices directly (evaluate.py:166), which is only meaningful when
        # the unique head and tail stores coincide; guard that precondition
        # instead of silently mis-indexing.
        heads_store = _np(batch.head.drugs)
        tails_store = _np(batch.tail.drugs)
        if heads_store.shape == tails_store.shape and np.array_equal(
                heads_store, tails_store):
            hi2 = np.concatenate([hi, ti])
            ti2 = np.concatenate([ti, hi])
            return hi2, ti2, np.tile(lb, 2), np.tile(pn, 2), np.tile(m, 2)
        # Remap through global drug ids so both directions can still be
        # scored when the collator deduped each side separately.
        tail_in_head = _rows_in_store(tail_g, heads_store)
        head_in_tail = _rows_in_store(head_g, tails_store)
        if tail_in_head is not None and head_in_tail is not None:
            hi2 = np.concatenate([hi, tail_in_head])
            ti2 = np.concatenate([ti, head_in_tail])
            return hi2, ti2, np.tile(lb, 2), np.tile(pn, 2), np.tile(m, 2)
        import warnings

        warnings.warn(
            f"bidirectional eval for asymmetric eval_type '{eval_type}' "
            "skipped: unique head/tail stores differ and the reverse "
            "direction's drugs are not all present in the opposite store; "
            "scoring one direction only (reference undirects here, "
            "evaluate.py:166)",
            stacklevel=2,
        )
    return hi, ti, lb, pn, m


def _rows_in_store(global_ids: np.ndarray, store: np.ndarray):
    """Rows of `store` holding each of `global_ids`, or None if any id is
    absent from the store."""
    lut = np.full(int(max(store.max(), global_ids.max())) + 1, -1, np.int64)
    lut[store] = np.arange(len(store))
    rows = lut[global_ids]
    return rows if (rows >= 0).all() else None


class Evaluator:
    """evaluate_ft equivalent: sweeps eval types for a split, returns the
    model-selection key metric (macro AUPRC of the mode's eval type).

    The model is evaluated as it stands (its current weights), in eval
    mode for each call and back in its own mode afterwards."""

    def __init__(self, model: MadrigalMultilabel, finetune_mode: str,
                 task: str = "multilabel", k: int = K, logger=None):
        self.model = model
        self.finetune_mode = finetune_mode
        self.task = task
        self.k = k
        self.logger = logger
        self.best_metrics: Dict[str, float] = {}

    def _embed(self, batch: DDIBatch, kg, masks_head, masks_tail):
        dev = batch.head.masks.device
        head = dataclasses.replace(
            batch.head, masks=torch.as_tensor(masks_head, device=dev))
        tail = dataclasses.replace(
            batch.tail, masks=torch.as_tensor(masks_tail, device=dev))
        return self.model.embed_pair(head, tail, kg)

    def evaluate_ddi(self, batch: DDIBatch, kg, eval_type: str,
                     split: str) -> Tuple[float, Dict[str, float]]:
        masks_head, masks_tail = get_evaluate_masks(
            _np(batch.head.masks), _np(batch.tail.masks),
            eval_type, self.finetune_mode,
        )
        hi, ti, lb, pn, w = _direction_arrays(split, eval_type, batch)
        dev = batch.head_idx.device
        with eval_mode(self.model):
            z_head, z_tail = self._embed(batch, kg, masks_head, masks_tail)
            preds = torch.sigmoid(self.model.decoder.triples(
                z_head[torch.as_tensor(hi, device=dev).long()],
                z_tail[torch.as_tensor(ti, device=dev).long()],
                torch.as_tensor(lb, device=dev))).cpu().numpy()
        keep = w.astype(bool)
        metrics, _ = get_metrics(
            preds[keep], pn[keep], lb[keep], k=self.k, task=self.task,
            average=AVERAGE, logger=self.logger,
        )
        key = float(metrics[KEY_METRIC])
        bk = f"best_{split}_{eval_type}_{KEY_METRIC}"
        if bk not in self.best_metrics or key > self.best_metrics[bk]:
            for name, v in metrics.items():
                self.best_metrics[f"best_{split}_{eval_type}_{name}"] = (
                    float(np.asarray(v)) if np.ndim(v) == 0 else v
                )
        return key, metrics

    def evaluate_ft(self, batch: DDIBatch, kg, split: str,
                    eval_types=None) -> float:
        base = split.split("_")[-1]
        if "between" in split:
            sel = MODEL_SELECTION_EVAL_TYPE["between"].get(
                self.finetune_mode, "full_full")
        elif "within" in split:
            sel = MODEL_SELECTION_EVAL_TYPE["within"].get(
                self.finetune_mode, "full_full")
        else:
            sel = MODEL_SELECTION_EVAL_TYPE["plain"].get(
                self.finetune_mode, "full_full")
        key_metric = float("nan")
        first_key = float("nan")
        for i, et in enumerate(eval_types or SPLIT_EVAL_TYPES[base]):
            k, metrics = self.evaluate_ddi(batch, kg, et, split)
            if self.logger:
                self.logger.info(
                    f"{split} {et}: " + ", ".join(
                        f"{n}={float(np.mean(v)):.4f}"
                        for n, v in metrics.items()
                    )
                )
            if i == 0:
                first_key = k
            if et == sel:
                key_metric = k
        if np.isnan(key_metric) and not np.isnan(first_key):
            # a custom eval_types list omitted the mode's model-selection
            # type; fall back to the first swept type so checkpoint
            # selection / early stopping never run on NaN
            import warnings

            warnings.warn(
                f"model-selection eval type '{sel}' for mode "
                f"'{self.finetune_mode}' not in swept eval_types; using "
                "the first swept type's key metric instead",
                stacklevel=2,
            )
            key_metric = first_key
        return key_metric


def _write_csv(path: str, columns: Dict[str, np.ndarray]) -> None:
    """One column per entry, as DataFrame(columns).to_csv(index=False)
    writes it: numbers in their shortest round-trip form, NaN empty."""
    cols = [np.asarray(v) for v in columns.values()]

    def cell(v):
        if isinstance(v, (float, np.floating)) and np.isnan(v):
            return ""
        return str(v)

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(columns))
        for row in zip(*cols):
            w.writerow([cell(v) for v in row])


def save_scores_and_stratified_metrics(
    preds, pos_neg, labels, out_dir: str, split: str, eval_type: str,
    finetune_mode: str, label_map=None, k: int = K,
):
    """Score + label-stratified-metric CSV export (the reference's
    save_scores path, evaluate.py:216-247 + the commented export at
    evaluate.py:252-258): per-triple scores and per-label metric rows."""
    os.makedirs(out_dir, exist_ok=True)
    preds = np.asarray(preds)
    pos_neg = np.asarray(pos_neg)
    labels = np.asarray(labels)

    scores_path = os.path.join(
        out_dir, f"{split}_{eval_type}_{finetune_mode}_scores.csv")
    _write_csv(scores_path, {"pred_score": preds, "pos_neg": pos_neg,
                             "label": labels})

    stratified, pos_samples = get_metrics(
        preds, pos_neg, labels, k=k, task="multilabel", average=None,
    )
    uniq = np.unique(labels)
    rows = {name: np.asarray(vals) for name, vals in stratified.items()}
    rows["pos_samples"] = pos_samples.astype(int)
    rows["label"] = (
        np.asarray([label_map[int(u)] for u in uniq]) if label_map is not None
        else uniq
    )
    metrics_path = os.path.join(
        out_dir,
        f"{split}_{eval_type}_{finetune_mode}_label_stratified_metrics.csv",
    )
    _write_csv(metrics_path, rows)
    return scores_path, metrics_path
