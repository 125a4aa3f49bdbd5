"""Per-drug modality batch as tensors (port of
`madrigal_tpu/data/batch.py`).

Transcriptomics inputs are stacked [num_cell_lines, B, ...] so the
chemCPA encoder runs as one [16 * B] matmul batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .molgraph import MolGraphBatch


@dataclasses.dataclass(frozen=True)
class DrugModalityBatch:
    """All modality inputs for a batch of B drugs.

    masks: [B, NUM_MODALITIES] bool, True = modality MISSING.
    kg_rows: [B] int32 row into the KG drug-node table, -1 when the drug is
    not in the KG (its KG token is zero).
    """

    drugs: torch.Tensor  # [B] int32 global drug ids
    mols: MolGraphBatch
    kg_rows: torch.Tensor  # [B] int32
    cv: torch.Tensor  # [B, CV_INPUT_DIM]
    tx_sigs: torch.Tensor  # [C, B, TX_INPUT_DIM]
    tx_dosages: torch.Tensor  # [C, B]
    masks: torch.Tensor  # [B, M] bool
    extra_tabular: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict
    )

    @property
    def batch_size(self) -> int:
        return self.drugs.shape[0]
