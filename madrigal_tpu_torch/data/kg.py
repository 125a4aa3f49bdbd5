"""Heterogeneous knowledge-graph batches as tensors.

Port of `madrigal_tpu/data/kg.py` in its plain layout: per edge type,
src/dst/mask arrays in the input's edge order, padded to a multiple of
512 rows with masked edges, and one feature matrix per node type. With
`src_sort`, each edge type also carries the source-sorted layout that
the HGT's source-gather backward reduces over (`ops/gather.py`, kernel
K2). The JAX package's degree-chunked arenas and source-transpose arenas
are TPU layout workarounds whose outputs equal the plain path's, so they
are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

EdgeType = Tuple[str, str, str]  # (src_node_type, relation, dst_node_type)
PAD_MULTIPLE = 512


def edge_key(et: EdgeType) -> str:
    return "__".join(et)


@dataclasses.dataclass(frozen=True)
class KGMetadata:
    """Static schema: node types and canonical edge types."""

    node_types: Tuple[str, ...]
    edge_types: Tuple[EdgeType, ...]

    def __post_init__(self):
        object.__setattr__(self, "node_types", tuple(self.node_types))
        object.__setattr__(
            self, "edge_types", tuple(tuple(e) for e in self.edge_types)
        )


@dataclasses.dataclass(frozen=True)
class HeteroKGBatch:
    """Padded heterogeneous graph.

    node_feats: {node_type: [N_t, F_t]} float32.
    edge_src/edge_dst: {edge_key: [E_r]} int32 (padding -> 0, masked).
    edge_mask: {edge_key: [E_r]} bool.
    drug_index_map: [num_kg_drugs] int32 global drug id of each drug row.
    edge_src_order: {edge_key: [E_r]} int32 edge positions sorted by
      source node, real edges first (masked rows last); empty unless
      built with src_sort.
    edge_src_starts: {edge_key: [n_src + 1]} int32 boundary table over
      that order (starts[n_src] = number of real edges).
    """

    node_feats: Dict[str, torch.Tensor]
    edge_src: Dict[str, torch.Tensor]
    edge_dst: Dict[str, torch.Tensor]
    edge_mask: Dict[str, torch.Tensor]
    drug_index_map: torch.Tensor
    metadata: KGMetadata
    edge_src_order: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    edge_src_starts: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def num_nodes(self, node_type: str) -> int:
        return self.node_feats[node_type].shape[0]


def kg_schema(node_feats: Dict[str, np.ndarray],
              edge_types: Sequence[EdgeType]
              ) -> Tuple[Dict[str, int], Tuple[EdgeType, ...]]:
    """(node feature width per node type, sorted edge types): what the
    HGT needs to size its per-type weights."""
    dims = {nt: int(np.shape(v)[1]) for nt, v in sorted(node_feats.items())}
    return dims, tuple(sorted(tuple(e) for e in edge_types))


def _src_sort_layout(src: np.ndarray, msk: np.ndarray, n_src: int):
    """Source-sorted layout of one edge type (see
    HeteroKGBatch.edge_src_order): positions of real edges sorted by
    source node, masked rows last, and the [n_src + 1] boundary table."""
    key = np.where(msk, src.astype(np.int64), np.int64(n_src) + 1)
    order = np.argsort(key, kind="stable").astype(np.int32)
    n_real = int(msk.sum())
    starts = np.searchsorted(
        src[order[:n_real]], np.arange(n_src + 1)).astype(np.int32)
    return order, starts


def build_kg_batch(
    node_feats: Dict[str, np.ndarray],
    edge_indices: Dict[EdgeType, np.ndarray],  # [2, E] per canonical triple
    drug_ids: Sequence[int],
    device: torch.device | str | None = None,
    src_sort: bool = False,
) -> HeteroKGBatch:
    """Assemble a padded HeteroKGBatch on `device` (None: the card) from
    host arrays.

    Each edge type is padded to a multiple of PAD_MULTIPLE (at least one
    multiple) with masked rows, as the JAX package pads without budgets.
    src_sort adds the source-sorted layout of every edge type."""
    device = resolve_device(device)
    metadata = KGMetadata(
        node_types=tuple(sorted(node_feats)),
        edge_types=tuple(sorted(edge_indices)),
    )
    n_nodes = {k: np.shape(v)[0] for k, v in node_feats.items()}
    src_d, dst_d, mask_d, order_d, starts_d = {}, {}, {}, {}, {}
    for et, ei in edge_indices.items():
        k = edge_key(et)
        ei = np.asarray(ei)
        e = ei.shape[1]
        budget = max(-(-e // PAD_MULTIPLE), 1) * PAD_MULTIPLE
        src = np.zeros((budget,), np.int32)
        dst = np.zeros((budget,), np.int32)
        msk = np.zeros((budget,), bool)
        src[:e] = ei[0]
        dst[:e] = ei[1]
        msk[:e] = True
        src_d[k] = torch.from_numpy(src).to(device)
        dst_d[k] = torch.from_numpy(dst).to(device)
        mask_d[k] = torch.from_numpy(msk).to(device)
        if src_sort:
            order, starts = _src_sort_layout(src, msk, n_nodes[et[0]])
            order_d[k] = torch.from_numpy(order).to(device)
            starts_d[k] = torch.from_numpy(starts).to(device)
    return HeteroKGBatch(
        node_feats={k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
                    for k, v in node_feats.items()},
        edge_src=src_d,
        edge_dst=dst_d,
        edge_mask=mask_d,
        drug_index_map=torch.from_numpy(
            np.asarray(drug_ids, np.int32)).to(device),
        metadata=metadata,
        edge_src_order=order_d,
        edge_src_starts=starts_d,
    )


def remove_edges_attached_to_drugs(
    edge_indices: Dict[EdgeType, np.ndarray],
    drug_rows: np.ndarray,
    num_drug_nodes: int,
) -> Dict[EdgeType, np.ndarray]:
    """Drop KG edges touching the given drug-node rows (leakage control for
    eval drugs; reference: data_utils.py:279-293)."""
    keep_mask = np.ones((num_drug_nodes,), dtype=bool)
    keep_mask[drug_rows] = False
    out = {}
    for et, ei in edge_indices.items():
        src_t, _, dst_t = et
        ei = np.asarray(ei)
        keep = np.ones(ei.shape[1], dtype=bool)
        if src_t == "drug":
            keep &= keep_mask[ei[0]]
        if dst_t == "drug":
            keep &= keep_mask[ei[1]]
        out[et] = ei[:, keep]
    return out


def drug_row_lookup(drug_index_map: np.ndarray, num_total_drugs: int) -> np.ndarray:
    """Inverse map: global drug id -> row in the KG drug-node table, or -1
    (the drug's KG token is then zero)."""
    lut = np.full((num_total_drugs,), -1, dtype=np.int32)
    lut[np.asarray(drug_index_map)] = np.arange(len(drug_index_map), dtype=np.int32)
    return lut
