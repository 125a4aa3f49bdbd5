"""Heterogeneous knowledge-graph batches as tensors.

Port of `madrigal_tpu/data/kg.py` in its plain layout: per edge type,
src/dst/mask arrays padded to a multiple of 512 rows with masked edges,
and one feature matrix per node type, the edges in the input's order.
The port's destination sort and the layouts that kernel K2 sums over are
not built: the reference's sums take the ids as they are.
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
    """

    node_feats: Dict[str, torch.Tensor]
    edge_src: Dict[str, torch.Tensor]
    edge_dst: Dict[str, torch.Tensor]
    edge_mask: Dict[str, torch.Tensor]
    drug_index_map: torch.Tensor
    metadata: KGMetadata
    def num_nodes(self, node_type: str) -> int:
        return self.node_feats[node_type].shape[0]


def kg_schema(node_feats: Dict[str, np.ndarray],
              edge_types: Sequence[EdgeType]
              ) -> Tuple[Dict[str, int], Tuple[EdgeType, ...]]:
    """(node feature width per node type, sorted edge types): what the
    HGT needs to size its per-type weights."""
    dims = {nt: int(np.shape(v)[1]) for nt, v in sorted(node_feats.items())}
    return dims, tuple(sorted(tuple(e) for e in edge_types))


def build_kg_batch(
    node_feats: Dict[str, np.ndarray],
    edge_indices: Dict[EdgeType, np.ndarray],  # [2, E] per canonical triple
    drug_ids: Sequence[int],
    device: torch.device | str | None = None,
) -> HeteroKGBatch:
    """Assemble a padded HeteroKGBatch on `device` (None: the card) from
    host arrays. Each edge type is padded to a multiple of PAD_MULTIPLE
    (at least one multiple) with masked rows, as the JAX package pads
    without budgets."""
    device = resolve_device(device)
    metadata = KGMetadata(
        node_types=tuple(sorted(node_feats)),
        edge_types=tuple(sorted(edge_indices)),
    )
    n_nodes = {k: np.shape(v)[0] for k, v in node_feats.items()}
    src_np, dst_np, msk_np = {}, {}, {}
    for et, ei in edge_indices.items():
        k = edge_key(et)
        ei = np.asarray(ei)
        e = ei.shape[1]
        budget = max(-(-e // PAD_MULTIPLE), 1) * PAD_MULTIPLE
        src_np[k] = np.zeros((budget,), np.int32)
        dst_np[k] = np.zeros((budget,), np.int32)
        msk_np[k] = np.zeros((budget,), bool)
        src_np[k][:e] = ei[0]
        dst_np[k][:e] = ei[1]
        msk_np[k][:e] = True
    def put(arrays):
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    return HeteroKGBatch(
        node_feats={k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
                    for k, v in node_feats.items()},
        edge_src=put(src_np),
        edge_dst=put(dst_np),
        edge_mask=put(msk_np),
        drug_index_map=torch.from_numpy(
            np.asarray(drug_ids, np.int32)).to(device),
        metadata=metadata,
    )


def drug_row_lookup(drug_index_map: np.ndarray, num_total_drugs: int) -> np.ndarray:
    """Inverse map: global drug id -> row in the KG drug-node table, or -1
    (the drug's KG token is then zero)."""
    lut = np.full((num_total_drugs,), -1, dtype=np.int32)
    lut[np.asarray(drug_index_map)] = np.arange(len(drug_index_map), dtype=np.int32)
    return lut
