"""Finetune-mode masking engine (a copy of `madrigal_tpu/train/masking.py`,
which imports no JAX; the port keeps its own).

Host-side re-implementation of the reference's per-epoch modality-subset
sampling (reference: train_ddi_batch.py:136-266 + utils.py:51-145,360-409
powerset mask banks). Masks are numpy bool arrays [B, NUM_MODALITIES]
(True = masked/missing) fed into the jitted train step each epoch; shapes
are static so no recompilation occurs across epochs.
"""
from __future__ import annotations

from itertools import chain, combinations
from typing import List, Tuple

import numpy as np

from ..constants import NUM_CELL_LINES

ABLATION_SAMPLE_MODES = (
    "ablation_str_random_str+kg_full_sample",
    "ablation_str_random_str+cv_full_sample",
    "ablation_str_random_str+tx_full_sample",
    "ablation_str_random_str+kg+cv_full_sample",
    "ablation_str_random_str+kg+tx_full_sample",
    "ablation_str_random_str+cv+tx_full_sample",
)


def powerset(iterable):
    s = list(iterable)
    return chain.from_iterable(combinations(s, r) for r in range(len(s) + 1))


def ablation_unavailable_indices(
    finetune_mode: str, non_tx: List[str], num_cell_lines: int = NUM_CELL_LINES
) -> List[int]:
    """FINETUNE_MODE_ABLATION_FULL_UNAVAIL_MAP
    (reference: evaluate/eval_utils.py:112-144)."""
    n = len(non_tx)
    tx = [i + n for i in range(num_cell_lines)]
    if finetune_mode == "ablation_str_str":
        return list(range(1, n + num_cell_lines))
    if finetune_mode in ("ablation_kg_kg_subset", "ablation_kg_kg_padded"):
        return [i for i in range(n) if non_tx[i] != "kg"] + tx
    if finetune_mode == "ablation_cv_cv_padded":
        return [i for i in range(n) if non_tx[i] != "cv"] + tx
    if finetune_mode == "ablation_bs_bs_padded":
        return [i for i in range(n) if non_tx[i] != "bs"] + tx
    if finetune_mode == "ablation_tx_tx_padded":
        return list(range(n))
    if finetune_mode.startswith("ablation_str_random_str+"):
        mods = finetune_mode[len("ablation_str_random_"):-len("_full_sample")]
        keep = set(mods.split("+"))  # e.g. {'str','kg','tx'}
        out = [i for i in range(n) if non_tx[i] not in keep]
        if "tx" not in keep:
            out += tx
        return out
    raise KeyError(finetune_mode)


def subset_mask_bank(
    base_mask: np.ndarray, require_str: bool = False
) -> np.ndarray:
    """All subset masks of one drug's availability (1=masked convention;
    reference train_ddi_batch.py:199-215). Returns [num_subsets, M]."""
    avail = np.where(base_mask == 0)[0]
    subsets = [
        s for s in list(powerset(avail.tolist()))[1:]
        if (not require_str) or (0 in s)
    ]
    out = np.ones((len(subsets), base_mask.shape[0]), dtype=bool)
    for i, s in enumerate(subsets):
        out[i, list(s)] = False
    return out


class FinetuneMasker:
    """Per-epoch mask sampler for a finetune mode.

    Produces (masks_head, masks_tail, loss_plan) where loss_plan describes
    which forward passes the step runs ('single' or the 3-way
    str-str/X-X/str-X scheme, train_ddi_batch.py:281-351).
    """

    def __init__(self, finetune_mode: str, base_masks: np.ndarray,
                 non_tx: List[str], train_with_str_str: bool = False,
                 seed: int = 0):
        self.mode = finetune_mode
        self.base = np.asarray(base_masks, dtype=bool)
        self.non_tx = non_tx
        self.train_with_str_str = train_with_str_str
        self.rng = np.random.RandomState(seed)
        B, M = self.base.shape

        self.masks_str = np.ones_like(self.base)
        self.masks_str[:, 0] = False

        if finetune_mode == "full_full":
            self.fixed = self.base
        elif finetune_mode == "ablation_str_str" or "padded" in finetune_mode:
            m = np.zeros_like(self.base)
            m[:, ablation_unavailable_indices(finetune_mode, non_tx)] = True
            self.fixed = m
        elif finetune_mode == "ablation_kg_kg_subset":
            m = np.ones_like(self.base)
            m[:, non_tx.index("kg")] = False
            self.fixed = m
        elif finetune_mode == "str_full":
            self.fixed = self.base  # X = full availability
        elif finetune_mode == "str_str+random_sample":
            self.banks = [
                subset_mask_bank(b, require_str=True) for b in self.base
            ]
        elif finetune_mode == "full_str+random_sample":
            # full vs str+random-subset. The reference declares this mode
            # (parse_args.py:154) and wires its model-selection eval types
            # (eval_utils.py:72,91) but its train() dispatch raises
            # NotImplementedError for it (train_ddi_batch.py:266); semantics
            # follow the mode-name grammar: the fixed side is each drug's
            # FULL availability (as in str_full's tail), the sampled side is
            # a random str-containing subset (as in str_str+random_sample).
            self.fixed = self.base
            self.banks = [
                subset_mask_bank(b, require_str=True) for b in self.base
            ]
        elif finetune_mode in ("str_random_sample", "double_random"):
            self.banks = [subset_mask_bank(b) for b in self.base]
        elif finetune_mode in ABLATION_SAMPLE_MODES:
            unavail = ablation_unavailable_indices(finetune_mode, non_tx)
            base = self.base.copy()
            base[:, unavail] = True
            self.banks = [subset_mask_bank(b) for b in base]
        else:
            raise NotImplementedError(finetune_mode)

    @property
    def uses_three_way_loss(self) -> bool:
        return self.mode in (
            "str_str+random_sample", "str_random_sample", "str_full",
            "full_str+random_sample",
        ) + ABLATION_SAMPLE_MODES

    def edges_directed_only(self) -> bool:
        """Modes whose loss uses only the directed (h<t) edge list
        (train_ddi_batch.py:141-146,160-165)."""
        return self.mode in (
            "full_full", "ablation_str_str", "ablation_kg_kg_subset",
        ) or "padded" in self.mode

    def sample_epoch(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (masks_head, masks_tail) for this epoch."""
        if self.mode == "double_random":
            h, t = [], []
            for bank in self.banks:
                if len(bank) > 1:
                    i, j = self.rng.permutation(len(bank))[:2]
                else:
                    i = j = 0
                h.append(bank[i])
                t.append(bank[j])
            return np.stack(h), np.stack(t)
        if self.mode in ("str_str+random_sample", "str_random_sample",
                         "full_str+random_sample") + ABLATION_SAMPLE_MODES:
            # masks_X: random non-str-only subset (reference offsets by +1 to
            # skip the str-only mask, train_ddi_batch.py:252)
            X = []
            for bank in self.banks:
                if len(bank) > 1:
                    X.append(bank[self.rng.randint(1, len(bank))])
                else:
                    X.append(bank[0])
            if self.mode == "full_str+random_sample":
                # the fixed side is full availability, not str-only
                return self.fixed, np.stack(X)
            return self.masks_str, np.stack(X)
        if self.mode == "str_full":
            return self.masks_str, self.fixed
        return self.fixed, self.fixed
