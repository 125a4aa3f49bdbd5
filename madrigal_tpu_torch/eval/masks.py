"""Eval-type modality-mask algebra (a copy of `madrigal_tpu/eval/masks.py`,
which imports no JAX; the port keeps its own).

Port of the reference's evaluation mask construction
(reference: madrigal/evaluate/eval_utils.py:13-144,253-305):
eval types like 'str_str', 'full_full', 'str+tx_full' select which
modalities the head/tail encoders may see, intersected with per-drug
availability; ablation finetune modes force never-seen modalities off.
"""
from __future__ import annotations

from itertools import chain, combinations
from typing import Dict, List

import numpy as np

from ..constants import CELL_LINES, NON_TX_MODALITIES, NUM_MODALITIES
from ..train.masking import ablation_unavailable_indices


def powerset(iterable):
    s = list(iterable)
    return chain.from_iterable(combinations(s, r) for r in range(len(s) + 1))


def modality2number_list() -> Dict[str, List[int]]:
    out = {mod: [i] for i, mod in enumerate(NON_TX_MODALITIES)}
    n = len(NON_TX_MODALITIES)
    out.update({
        f"tx_{cl}": [i + n] for i, cl in enumerate(CELL_LINES)
    })
    out["tx"] = [i + n for i in range(len(CELL_LINES))]
    return out


MODALITY2NUMBER_LIST = modality2number_list()

# model-selection eval type per finetune mode (eval_utils.py:55-111)
MODEL_SELECTION_EVAL_TYPE = {
    "between": {
        "ablation_str_str": "str_str",
        "ablation_kg_kg_subset": "kg_kg",
        "ablation_kg_kg_padded": "kg_kg",
        "ablation_cv_cv_padded": "cv_cv",
        "ablation_tx_tx_padded": "tx_tx",
        "ablation_str_random_str+kg_full_sample": "str_full",
        "ablation_str_random_str+cv_full_sample": "str_full",
        "ablation_str_random_str+tx_full_sample": "str+tx_full",
        "ablation_str_random_str+kg+cv_full_sample": "str_full",
        "ablation_str_random_str+kg+tx_full_sample": "str+tx_full",
        "ablation_str_random_str+cv+tx_full_sample": "str+tx_full",
        "str_full": "str_full",
        "full_full": "str+tx_full",
        "double_random": "str+tx_full",
        "str_random_sample": "str+tx_full",
        "str_str+random_sample": "str+tx_full",
        "full_str+random_sample": "str+tx_full",
    },
    "within": {
        "ablation_str_str": "str_str",
        "ablation_kg_kg_subset": "kg_kg",
        "ablation_kg_kg_padded": "kg_kg",
        "ablation_cv_cv_padded": "cv_cv",
        "ablation_tx_tx_padded": "tx_tx",
        "str_full": "str_str",
        "full_full": "str_str",
        "double_random": "str_str",
        "str_random_sample": "str_str",
        "str_str+random_sample": "str_str",
        "full_str+random_sample": "str_str",
    },
    "plain": {
        "ablation_str_str": "str_str",
        "ablation_kg_kg_subset": "kg_kg",
        "ablation_kg_kg_padded": "kg_kg",
        "ablation_cv_cv_padded": "cv_cv",
        "ablation_tx_tx_padded": "tx_tx",
        "str_full": "full_full",
        "full_full": "full_full",
        "double_random": "full_full",
        "str_random_sample": "full_full",
        "str_str+random_sample": "full_full",
        "full_str+random_sample": "full_full",
    },
}


def get_full_evaluate_mask_for_finetune_mode(finetune_mode, base_masks):
    """'full' side of an eval type (eval_utils.py:253-268)."""
    masks = np.array(base_masks, dtype=bool, copy=True)
    if "ablation" in finetune_mode:
        unavail = ablation_unavailable_indices(
            finetune_mode, list(NON_TX_MODALITIES)
        )
        masks[:, unavail] = True
        if "kg_kg" in finetune_mode:
            masks[:, MODALITY2NUMBER_LIST["kg"][0]] = False
        elif "cv_cv" in finetune_mode:
            masks[:, MODALITY2NUMBER_LIST["cv"][0]] = False
        elif "tx_tx" in finetune_mode:
            masks[:, len(NON_TX_MODALITIES):] = False
    return masks


def get_modality_evaluate_mask(base_masks, modality: str):
    """Single- or multi-modality eval mask (eval_utils.py:271-284).

    Without '+': ONLY that modality visible (even if unavailable -- the
    reference forces it on). With '+': keep availability for the listed
    modalities, mask everything else.
    """
    base_masks = np.asarray(base_masks, dtype=bool)
    if "+" not in modality:
        cols = MODALITY2NUMBER_LIST[modality]
        masks = np.ones_like(base_masks)
        masks[:, cols] = False
        return masks
    cols: List[int] = []
    for m in modality.split("+"):
        cols.extend(MODALITY2NUMBER_LIST[m])
    must_mask = sorted(set(range(NUM_MODALITIES)) - set(cols))
    masks = base_masks.copy()
    masks[:, must_mask] = True
    return masks


def get_evaluate_masks(head_masks_base, tail_masks_base, eval_type: str,
                       finetune_mode: str):
    """(head_masks, tail_masks) for an eval type (eval_utils.py:287-305)."""
    head_t, tail_t = eval_type.split("_")
    if head_t == "full":
        head = get_full_evaluate_mask_for_finetune_mode(
            finetune_mode, head_masks_base
        )
    else:
        head = get_modality_evaluate_mask(head_masks_base, head_t)
    if tail_t == "full":
        tail = get_full_evaluate_mask_for_finetune_mode(
            finetune_mode, tail_masks_base
        )
    else:
        tail = get_modality_evaluate_mask(tail_masks_base, tail_t)
    return head, tail
