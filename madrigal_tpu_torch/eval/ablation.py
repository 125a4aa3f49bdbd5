"""Modality-ablation study (port of `madrigal_tpu/eval/ablation.py`): the
computational core of the reference's fig2 notebooks run as a library.

The reference mutates collated batches in notebook cells
(reference: notebooks/fig2/fig2_modality_ablations.ipynb
`batch_mask_mutate` — force-mask the modalities OUTSIDE a chosen
subset for drugs that have every modality, re-run `make_predictions`,
tabulate per-label metrics, and compare modality subsets with paired
Wilcoxon tests; fig2/fig2_model_analyses.ipynb `get_drug_specific_scores`
+ mannwhitneyu). Here the mask mutation is a pure function over the
[N, M] boolean availability masks (True = missing, the shared
convention of data/collate.py and eval/masks.py), so it composes with
`eval.predict.make_predictions` / `embed_all_drugs` without touching
collator internals, and the study loop is a tested function instead of
a notebook. The port's collated batches hold torch tensors; the masks
are mutated on the host and put back on the batch's device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import NON_TX_MODALITIES
from .masks import MODALITY2NUMBER_LIST

MODALITIES: Tuple[str, ...] = tuple(NON_TX_MODALITIES) + ("tx",)


def full_modality_drugs(masks: np.ndarray) -> np.ndarray:
    """Drug indices with EVERY modality present — the reference ablates
    only these, so a forced-off modality is the single varying factor
    (fig2_modality_ablations.ipynb `full_mod_drug_set`). tx counts as
    present when any cell line is unmasked."""
    masks = np.asarray(masks, bool)
    non_tx_ok = ~masks[:, : len(NON_TX_MODALITIES)].any(axis=1)
    tx_ok = ~masks[:, len(NON_TX_MODALITIES):].all(axis=1)
    return np.flatnonzero(non_tx_ok & tx_ok)


def force_modality_masks(
    masks: np.ndarray,
    avail_mods: Sequence[str],
    drug_subset: Optional[np.ndarray] = None,
) -> np.ndarray:
    """`batch_mask_mutate` as a pure mask transform: for drugs in
    `drug_subset` (default: every drug), mask out (True) each modality
    NOT in `avail_mods`; existing missingness is preserved (a mask is
    only ever turned on, never off). Modality names per
    constants.MODALITY2NUMBER_LIST ('tx' covers all cell-line columns).
    """
    masks = np.array(masks, dtype=bool, copy=True)
    bad = set(avail_mods) - set(MODALITIES)
    if bad:
        raise ValueError(f"unknown modalities {sorted(bad)}; "
                         f"choose from {MODALITIES}")
    rows = (slice(None) if drug_subset is None
            else np.asarray(drug_subset, np.int64))
    for m in MODALITIES:
        if m in avail_mods:
            continue
        for col in MODALITY2NUMBER_LIST[m]:
            masks[rows, col] = True
    return masks


def _ablate_batch(batch, avail_mods: Sequence[str],
                  full_mod_set: np.ndarray, sides: Sequence[str]):
    """Mutated copy of a collated DDI batch (fig2's head/tail control:
    sides=('head',) ablates test drugs, ('tail',) train drugs,
    both = all)."""
    repl = {}
    for side in sides:
        view = getattr(batch, side)
        drugs = view.drugs.cpu().numpy()
        in_set = np.isin(drugs, full_mod_set)
        masks = force_modality_masks(
            view.masks.cpu().numpy(), avail_mods, np.flatnonzero(in_set))
        repl[side] = dataclasses.replace(
            view, masks=torch.as_tensor(masks, device=view.masks.device))
    return dataclasses.replace(batch, **repl)


def default_modality_combos(
    max_size: Optional[int] = None,
) -> List[Tuple[str, ...]]:
    """Every non-empty modality subset, smallest first (the fig2 sweep
    enumerates itertools.combinations over the 4 modalities)."""
    out: List[Tuple[str, ...]] = []
    for r in range(1, len(MODALITIES) + 1):
        if max_size is not None and r > max_size:
            break
        out.extend(itertools.combinations(MODALITIES, r))
    return out


def modality_ablation_study(
    model,
    batch,
    kg,
    finetune_mode: str,
    eval_type: str = "full_full",
    combos: Optional[Iterable[Sequence[str]]] = None,
    sides: Sequence[str] = ("head", "tail"),
    full_mod_set: Optional[np.ndarray] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-label metric table for each modality subset.

    For each combo, drugs in `full_mod_set` (default: the batch's
    full-modality drugs) keep only that combo's modalities, predictions
    rerun through `eval.predict.make_predictions`, and per-label metrics
    (average=None) are tabulated — the reference's
    `get_label_metrics`/`get_label_metrics_all_mod_train` loop.

    Returns {combo_name: {metric: [n_labels] array, 'labels': label ids,
    'pos_samples': per-label positives}}.
    """
    from .metrics import get_metrics
    from .predict import make_predictions

    if full_mod_set is None:
        sets = [full_modality_drugs(getattr(batch, s).masks.cpu().numpy())
                for s in sides]
        ids = [getattr(batch, s).drugs.cpu().numpy()[x]
               for s, x in zip(sides, sets)]
        full_mod_set = np.unique(np.concatenate(ids)) if ids else np.array([])
    keep = batch.mask.cpu().numpy().ravel()  # drop collator padding triples
    ys = batch.pos_neg.cpu().numpy().ravel()[keep]
    labels = batch.labels.cpu().numpy().ravel()[keep]
    if combos is None:
        combos = default_modality_combos()

    out: Dict[str, Dict[str, np.ndarray]] = {}
    for combo in combos:
        mutated = _ablate_batch(batch, combo, full_mod_set, sides)
        preds = make_predictions(
            model, mutated, kg, eval_type, finetune_mode
        ).ravel()[keep]
        metrics, pos = get_metrics(preds, ys, labels, average=None)
        row = {k: np.asarray(v) for k, v in metrics.items()}
        row["labels"] = np.unique(labels)
        row["pos_samples"] = np.asarray(pos)
        out["+".join(combo)] = row
    return out


def compare_ablations(
    table: Dict[str, Dict[str, np.ndarray]],
    combo_a: str,
    combo_b: str,
    metric: str = "auprc",
    alternative: str = "two-sided",
):
    """Paired Wilcoxon signed-rank test of one metric across labels
    between two modality subsets (fig2_modality_ablations.ipynb's
    scipy.stats.wilcoxon comparisons). NaN labels (e.g. no positives)
    are dropped pairwise. Returns the scipy result."""
    from scipy.stats import wilcoxon

    a = np.asarray(table[combo_a][metric], np.float64)
    b = np.asarray(table[combo_b][metric], np.float64)
    keep = np.isfinite(a) & np.isfinite(b)
    return wilcoxon(a[keep], b[keep], alternative=alternative)


def drug_specific_values(tensor, drug: int,
                         labels: Optional[Sequence[int]] = None,
                         exclude_self: bool = True) -> np.ndarray:
    """[L', N] tensor values of every pair involving one drug
    (fig2_model_analyses.ipynb `get_drug_specific_scores`; feeds
    mannwhitneyu group comparisons via analysis.rank_enrichment).
    Streams one outcome slice at a time; the self-pair is NaN'd out by
    default (the notebooks drop the diagonal)."""
    L = tensor.shape[0]
    lab = np.arange(L) if labels is None else np.asarray(labels, np.int64)
    out = np.empty((len(lab), tensor.shape[1]), np.float64)
    for i, l in enumerate(lab):
        out[i] = np.asarray(tensor[l][drug], np.float64)
        if exclude_self:
            out[i, drug] = np.nan
    return out
