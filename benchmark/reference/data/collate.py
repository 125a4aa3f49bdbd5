"""DDI collator: long-format edge table -> tensor batches.

Port of `madrigal_tpu/data/collate.py` (reference LongDDIDataCollator,
madrigal/data/data.py:759-1012): unique head/tail dedup with inverse
indices, train-edge undirecting, the table's fixed negatives, and the
per-drug modality gathers (molecules, KG row lookup, cv/tx rows). It reads
the numpy `EdgeTable` of `data/synthetic.py`. The port's structured
negatives, KG subgraph sampling, between splits and shared drug-table
cache are not kept: no cell runs them.

The KG batch is the full KG sorted by destination (`data/kg.py`); its
molecule batches are packed as the port packs them (`data/molgraph.py`).
Every row of a collated batch is real (`mask` is all True).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .batch import DrugModalityBatch
from .kg import HeteroKGBatch, build_kg_batch, drug_row_lookup
from .molgraph import pack_molecules
from .synthetic import EdgeTable, SyntheticDataset


@dataclasses.dataclass(frozen=True)
class DDIBatch:
    """One collated DDI batch (reference collator output dict)."""

    head: DrugModalityBatch
    tail: DrugModalityBatch
    head_idx: torch.Tensor  # [T] index into head.drugs
    tail_idx: torch.Tensor  # [T] index into tail.drugs
    labels: torch.Tensor  # [T]
    pos_neg: torch.Tensor  # [T] 1=positive, 0=negative
    mask: torch.Tensor  # [T] bool; False rows are padding (none here)


class DDICollator:
    """Host-side collator over a drug store; tensors land on `device`
    (None: the card)."""

    def __init__(self, ds: SyntheticDataset, split: str = "train",
                 seed: int = 0, device: torch.device | str | None = None):
        self.ds = ds
        self.split = split
        self.device = resolve_device(device)
        self.kg_row_lut = drug_row_lookup(ds.kg_drug_ids, ds.num_drugs)

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def drug_batch(self, drug_ids: np.ndarray) -> DrugModalityBatch:
        ds = self.ds
        drug_ids = np.asarray(drug_ids, np.int64)
        mols = pack_molecules([ds.molecules[int(i)] for i in drug_ids],
                              device=self.device)
        return DrugModalityBatch(
            drugs=self._t(drug_ids.astype(np.int32)),
            mols=mols,
            kg_rows=self._t(self.kg_row_lut[drug_ids]),
            cv=self._t(ds.cv_table[drug_ids]),
            tx_sigs=self._t(ds.tx_table[:, drug_ids]),
            tx_dosages=self._t(ds.tx_dosages[:, drug_ids]),
            masks=self._t(ds.masks[drug_ids]),
            extra_tabular={
                mod: self._t(tab[drug_ids])
                for mod, tab in getattr(ds, "extra_tabular", {}).items()
            },
        )

    def kg_batch(self) -> HeteroKGBatch:
        """The full-KG batch (the reference's default path,
        data_utils.py:330-332), sorted by destination."""
        ds = self.ds
        return build_kg_batch(ds.kg_node_feats, ds.kg_edge_indices,
                              ds.kg_drug_ids, device=self.device)

    def __call__(
        self, rows: Optional[EdgeTable] = None, build_kg: bool = True,
    ) -> Tuple[DDIBatch, Optional[HeteroKGBatch]]:
        """Collate an edge table (defaults to the full table). With
        build_kg=False the KG slot is None."""
        t = self.ds.edge_df if rows is None else rows
        pos = np.stack([t["head"], t["tail"]], 1).astype(np.int64)
        labels = t["label_indexed"].astype(np.int64)

        if self.split != "train":
            raise NotImplementedError(f"split {self.split!r}")
        neg = np.concatenate([
            np.stack([pos[:, 0], t["neg_tail"]], 1),
            np.stack([t["neg_head"], pos[:, 1]], 1),
        ])
        neg_labels = np.tile(labels, 2)

        # undirect (reference data.py:863-867)
        pos = np.concatenate([pos, pos[:, ::-1]])
        neg = np.concatenate([neg, neg[:, ::-1]])
        labels = np.tile(labels, 2)
        neg_labels = np.tile(neg_labels, 2)

        all_heads = np.concatenate([pos[:, 0], neg[:, 0]])
        all_tails = np.concatenate([pos[:, 1], neg[:, 1]])
        all_labels = np.concatenate([labels, neg_labels])
        pos_neg = np.concatenate(
            [np.ones_like(labels), np.zeros_like(neg_labels)]
        )
        uniq_heads, head_inv = np.unique(all_heads, return_inverse=True)
        uniq_tails, tail_inv = np.unique(all_tails, return_inverse=True)

        batch = DDIBatch(
            head=self.drug_batch(uniq_heads),
            tail=self.drug_batch(uniq_tails),
            head_idx=self._t(head_inv.astype(np.int32)),
            tail_idx=self._t(tail_inv.astype(np.int32)),
            labels=self._t(all_labels.astype(np.int32)),
            pos_neg=self._t(pos_neg.astype(np.int32)),
            mask=self._t(np.ones(len(all_labels), bool)),
        )
        return batch, (self.kg_batch() if build_kg else None)
