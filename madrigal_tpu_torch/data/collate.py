"""DDI collator: long-format edge table -> tensor batches.

Port of `madrigal_tpu/data/collate.py` (reference LongDDIDataCollator,
madrigal/data/data.py:759-1012): unique head/tail dedup with inverse
indices, train-edge undirecting, fixed or structured negatives, and the
per-drug modality gathers (molecules, KG row lookup, cv/tx rows). It reads
the numpy `EdgeTable` of `data/synthetic.py`.

The KG batch is sorted by destination and carries the layouts kernel K2
sums over (`data/kg.py`), with the source-sorted layout of the
backward's source gathers added under `kg_src_sort`; its molecule
batches carry theirs (`data/molgraph.py`). `full_drug_table` collates
against the whole drug table (head/tail indices are then global drug
ids) and `drug_table_cache` lets collators share their drug batches, as
in the JAX package. The JAX collator's static-shape budgets (node, edge
and pair padding for XLA) and its degree-chunked KG layout have no
counterpart: PyTorch runs each batch at its own shape, so every row of a
collated batch is real (`mask` is all True).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .batch import DrugModalityBatch
from .kg import HeteroKGBatch, build_kg_batch, drug_row_lookup
from .kg_sampling import sample_kg_subgraph
from .molgraph import pack_molecules
from .negative_sampling import structured_negative_sampling_multilabel
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

    def __init__(
        self,
        ds: SyntheticDataset,
        split: str = "train",
        num_negative_samples_per_pair: Optional[int] = None,
        negative_sampling_probs_type: str = "uniform",
        seed: int = 0,
        device: torch.device | str | None = None,
        kg_src_sort: bool = False,
        drug_table_cache: Optional[dict] = None,
        full_drug_table: bool = False,
    ):
        self.ds = ds
        self.split = split
        self.device = resolve_device(device)
        self.kg_src_sort = kg_src_sort
        # drug batches keyed by their drug-id set, shared by every
        # collator given the same dict (one device copy of the tables)
        self.drug_table_cache = drug_table_cache
        # collate against the whole [0, N) drug table: head/tail indices
        # become global drug ids and every batch's head and tail are the
        # one cached full-table batch
        self.full_drug_table = full_drug_table
        if full_drug_table and drug_table_cache is None:
            self.drug_table_cache = {}
        self.num_neg = num_negative_samples_per_pair
        self.rng = np.random.RandomState(seed)
        self.kg_row_lut = drug_row_lookup(ds.kg_drug_ids, ds.num_drugs)

        if self.num_neg:
            t = ds.edge_df
            self.gt_edges = np.stack([t["head"], t["tail"]], 1)
            self.valid_indices = np.unique(self.gt_edges)
            self.gt_labels = t["label_indexed"]
            if negative_sampling_probs_type == "uniform":
                self.neg_probs = None
            elif negative_sampling_probs_type in ("degree", "degree_w2v"):
                counts = np.bincount(
                    self.gt_edges.flatten(),
                    minlength=int(self.valid_indices.max()) + 1,
                ).astype(np.float64)
                if negative_sampling_probs_type == "degree_w2v":
                    counts = counts ** 0.75
                self.neg_probs = counts / counts.sum()
            else:
                raise ValueError(negative_sampling_probs_type)

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def drug_batch(self, drug_ids: np.ndarray) -> DrugModalityBatch:
        ds = self.ds
        drug_ids = np.asarray(drug_ids, np.int64)
        cache = self.drug_table_cache
        key = (drug_ids.tobytes(), self.device)
        if cache is not None and key in cache:
            return cache[key]
        mols = pack_molecules([ds.molecules[int(i)] for i in drug_ids],
                              device=self.device)
        out = DrugModalityBatch(
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
        if cache is not None:
            cache[key] = out
        return out

    def kg_batch(self, seed_drug_ids=None,
                 kg_sampling_num_neighbors: Optional[int] = None,
                 kg_sampling_num_layers: int = 2) -> HeteroKGBatch:
        """The full-KG batch (the reference's default path,
        data_utils.py:330-332), sorted by destination with its K2
        layouts, and the source-sorted layout when the collator was built
        with kg_src_sort. With `kg_sampling_num_neighbors`, a drug-rooted
        sampled subgraph instead (`data/kg_sampling.py`; the reference's
        sample_kg_data), seeded at the KG drug rows of `seed_drug_ids`
        (all drugs when None) and drawn from the collator's rng. Its drug
        table holds the kept drugs only: gather from it through its
        drug_index_map (`kg.drug_row_lookup`)."""
        ds = self.ds
        if kg_sampling_num_neighbors:
            seeds = (np.nonzero(np.isin(ds.kg_drug_ids, seed_drug_ids))[0]
                     if seed_drug_ids is not None
                     else np.arange(len(ds.kg_drug_ids)))
            sub, _ = sample_kg_subgraph(
                ds.kg_node_feats, ds.kg_edge_indices, ds.kg_drug_ids, seeds,
                kg_sampling_num_neighbors, kg_sampling_num_layers,
                rng=self.rng, device=self.device, src_sort=self.kg_src_sort)
            return sub
        return build_kg_batch(ds.kg_node_feats, ds.kg_edge_indices,
                              ds.kg_drug_ids, device=self.device,
                              src_sort=self.kg_src_sort)

    def __call__(
        self, rows: Optional[EdgeTable] = None, build_kg: bool = True,
    ) -> Tuple[DDIBatch, Optional[HeteroKGBatch]]:
        """Collate an edge table (defaults to the full table). With
        build_kg=False the KG slot is None."""
        t = self.ds.edge_df if rows is None else rows
        pos = np.stack([t["head"], t["tail"]], 1).astype(np.int64)
        labels = t["label_indexed"].astype(np.int64)

        if self.num_neg:
            nh, nt = structured_negative_sampling_multilabel(
                pos.T, labels, self.valid_indices, self.gt_edges.T,
                self.gt_labels, probs=self.neg_probs, rng=self.rng,
            )
            neg = np.concatenate(
                [np.stack([pos[:, 0], nt], 1), np.stack([nh, pos[:, 1]], 1)]
            )
        elif self.split in ("val_between", "test_between"):
            # between splits corrupt only the train-side tail, twice
            # (reference data.py:850-854: neg_tail_1 / neg_tail_2)
            neg = np.concatenate([
                np.stack([pos[:, 0], t["neg_tail_1"]], 1),
                np.stack([pos[:, 0], t["neg_tail_2"]], 1),
            ])
        else:
            neg = np.concatenate([
                np.stack([pos[:, 0], t["neg_tail"]], 1),
                np.stack([t["neg_head"], pos[:, 1]], 1),
            ])
        neg_labels = np.tile(labels, 2)

        if self.split == "train":
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
        if self.full_drug_table:
            uniq_heads = uniq_tails = np.arange(self.ds.num_drugs)
            head_inv, tail_inv = all_heads, all_tails
        else:
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
