"""Modality-subset mask banks and samplers of stage-2 pretraining (a copy
of `madrigal_tpu/train/pretrain_masks.py`, numpy only; reference
madrigal/utils.py:51-145 get_pretrain_masks, utils.py:360-390
pretrain_modality_subset_sampler).

Per-drug banks of modality-subset masks derived from availability, with
sample-balanced subset probabilities (per-modality inverse-frequency
weights, tx downsampling correction), and the per-step samplers of the
pretrain modes. Fed the same `np.random.RandomState`, its banks and draws
equal the JAX package's exactly.
"""
from __future__ import annotations

import math
from itertools import chain, combinations
from typing import Dict, Tuple

import numpy as np

from ..constants import NUM_CELL_LINES


def powerset(iterable):
    s = list(iterable)
    return chain.from_iterable(combinations(s, r) for r in range(len(s) + 1))


def _subsets_to_masks(subsets, width) -> np.ndarray:
    out = np.ones((len(subsets), width), dtype=bool)
    for i, s in enumerate(subsets):
        out[i, list(s)] = False
    return out


def modality_probs(masks: np.ndarray, tx_downsample_ratio: float) -> np.ndarray:
    """Sample-balanced per-modality probabilities (utils.py:58-63)."""
    avail_counts = (1 - masks).sum(axis=0).astype(np.float64)
    probs = 1.0 / np.maximum(avail_counts, 1.0)
    probs[-NUM_CELL_LINES:] *= tx_downsample_ratio
    probs = probs / probs.sum()
    return np.clip(probs, 1e-6, 1.0)


def get_pretrain_masks(
    drugs: np.ndarray,
    masks: np.ndarray,
    pretrain_mode: str,
    pretrain_unbalanced: bool,
    pretrain_tx_downsample_ratio: float = 1.0,
) -> Dict[int, object]:
    """Per-drug subset-mask banks. Balanced modes return
    (masks_array, probs) tuples; unbalanced return masks_array."""
    masks = np.asarray(masks, dtype=np.int64)
    width = masks.shape[1]
    if not pretrain_unbalanced:
        mod_probs = modality_probs(masks, pretrain_tx_downsample_ratio)

    bank_of: Dict[tuple, object] = {}
    out: Dict[int, object] = {}
    for drug, mask in zip(drugs, masks):
        key_mask = mask.copy()
        if pretrain_mode in ("str_center", "str_center_uni",
                             "str_center_comb"):
            key_mask[0] = 1  # str never appears in the second branch
        key = tuple(key_mask)
        if key not in bank_of:
            avail = np.where(np.asarray(key) == 0)[0].tolist()
            if pretrain_mode in ("double_random", "str_kg", "str_center"):
                subsets = list(powerset(avail))[1:]
            elif pretrain_mode == "str_center_uni":
                subsets = [(i,) for i in avail]
            elif pretrain_mode == "str_center_comb":
                subsets = [s for s in list(powerset(avail))[1:] if len(s) > 1]
            else:
                raise NotImplementedError(pretrain_mode)
            subset_masks = _subsets_to_masks(subsets, width)
            if pretrain_unbalanced:
                bank_of[key] = subset_masks
            else:
                probs = []
                for s_mask in subset_masks:
                    on = np.where(s_mask == 0)[0]
                    off = np.asarray(
                        [i for i in avail if s_mask[i]], dtype=np.int64
                    )
                    p = mod_probs[on].prod() * (1 - mod_probs)[off].prod()
                    if pretrain_mode == "str_center":
                        p *= math.comb(len(avail), len(on))
                    probs.append(p)
                probs = np.asarray(probs)
                probs = probs / probs.sum() if probs.sum() > 0 else \
                    np.full(len(probs), 1.0 / len(probs))
                bank_of[key] = (subset_masks, probs)
        out[int(drug)] = bank_of[key]
    return out


def sample_pretrain_masks(
    all_subset_masks: Dict[int, object],
    drugs: np.ndarray,
    pretrain_mode: str,
    unbalanced: bool,
    rng: np.random.RandomState,
    width: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """One step's (mask1, mask2) per drug (utils.py:360-390), True =
    masked out.

    str_center* modes: branch 1 is always str-only; branch 2 sampled from
    the bank. double_random: two distinct random subsets. str_kg: fixed
    str vs kg.
    """
    B = len(drugs)
    if pretrain_mode in ("str_center", "str_center_uni", "str_center_comb"):
        aug1 = np.ones((B, width), dtype=bool)
        aug1[:, 0] = False
        aug2 = np.empty((B, width), dtype=bool)
        for i, d in enumerate(drugs):
            bank = all_subset_masks[int(d)]
            if unbalanced:
                aug2[i] = bank[rng.randint(len(bank))]
            else:
                subset_masks, probs = bank
                aug2[i] = subset_masks[rng.choice(len(subset_masks), p=probs)]
        return aug1, aug2
    if pretrain_mode == "double_random":
        aug1 = np.empty((B, width), dtype=bool)
        aug2 = np.empty((B, width), dtype=bool)
        for i, d in enumerate(drugs):
            bank = all_subset_masks[int(d)]
            bank = bank if unbalanced else bank[0]
            if len(bank) > 1:
                a, b = rng.permutation(len(bank))[:2]
            else:
                a = b = 0
            aug1[i], aug2[i] = bank[a], bank[b]
        return aug1, aug2
    if pretrain_mode == "str_kg":
        aug1 = np.ones((B, width), dtype=bool)
        aug2 = np.ones((B, width), dtype=bool)
        aug1[:, 0] = False
        aug2[:, 1] = False
        return aug1, aug2
    raise NotImplementedError(pretrain_mode)
