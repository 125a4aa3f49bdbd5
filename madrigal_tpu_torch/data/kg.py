"""Heterogeneous knowledge-graph batches as tensors.

Port of `madrigal_tpu/data/kg.py` in its plain layout: per edge type,
src/dst/mask arrays padded to a multiple of 512 rows with masked edges,
and one feature matrix per node type. By default the edges of each type
are sorted by destination, stably, as the JAX package's `sort_edges`
sorts them, and the batch carries the layouts that kernel K2 sums over
(`ops/segment.py`, `ops/gather.py`): each edge type's destination
boundary table, and each destination type's order and boundary table
over the concatenation of its edge types (the global-scope softmax).
With `src_sort`, each edge type also carries the source-sorted layout
that the source gathers' backward reduces over. The JAX package's
degree-chunked arenas and source-transpose arenas are TPU layout
workarounds whose outputs equal the plain path's, so they are not ported.
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
    edge_dst_starts: {edge_key: [n_dst + 1]} int32 boundary table of the
      edges, which are sorted by destination with the real edges first
      (starts[n_dst] = number of real edges); empty unless built with
      sort_edges.
    dst_type_order / dst_type_starts: {node_type: ...} the order
      ([sum of E_r] int32, real edges sorted by destination, masked rows
      last) and the [n + 1] boundary table of the concatenation, in
      metadata.edge_types order, of the edge arrays of every edge type
      into the node type; empty unless built with sort_edges.
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
    edge_dst_starts: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    dst_type_order: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    dst_type_starts: Dict[str, torch.Tensor] = dataclasses.field(
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


def _dst_starts(dst: np.ndarray, msk: np.ndarray, n_dst: int) -> np.ndarray:
    """[n_dst + 1] boundary table of one edge type whose real edges come
    first, sorted by destination."""
    n_real = int(msk.sum())
    if not msk[:n_real].all():
        raise ValueError("the real edges are not the leading rows")
    return np.searchsorted(dst[:n_real], np.arange(n_dst + 1)).astype(
        np.int32)


def _dst_type_layouts(edge_types: Sequence[EdgeType],
                      dst_d: Dict[str, np.ndarray],
                      mask_d: Dict[str, np.ndarray],
                      n_nodes: Dict[str, int]):
    """{node type: (order, starts)} over the concatenation, in
    `edge_types` order, of the edge arrays of every edge type into the
    node type (see HeteroKGBatch.dst_type_order). Each type's real edges
    are sorted by destination already, so the stable sort merges runs."""
    out = {}
    for nt in sorted({et[2] for et in edge_types}):
        keys = [edge_key(et) for et in edge_types if et[2] == nt]
        dst = np.concatenate([dst_d[k] for k in keys]).astype(np.int64)
        msk = np.concatenate([mask_d[k] for k in keys])
        order = np.argsort(np.where(msk, dst, np.int64(n_nodes[nt]) + 1),
                           kind="stable").astype(np.int32)
        n_real = int(msk.sum())
        out[nt] = (order, np.searchsorted(
            dst[order[:n_real]], np.arange(n_nodes[nt] + 1)).astype(np.int32))
    return out


def kg_layouts(metadata: KGMetadata, edge_src: Dict[str, np.ndarray],
               edge_dst: Dict[str, np.ndarray],
               edge_mask: Dict[str, np.ndarray], n_nodes: Dict[str, int],
               src_sort: bool) -> dict:
    """The K2 layouts of destination-sorted edge arrays (host numpy), as
    HeteroKGBatch fields of numpy arrays: edge_dst_starts, dst_type_order,
    dst_type_starts, and with src_sort edge_src_order and edge_src_starts.
    The real edges of each type must come first."""
    out = {"edge_dst_starts": {}, "dst_type_order": {},
           "dst_type_starts": {}, "edge_src_order": {},
           "edge_src_starts": {}}
    for et in metadata.edge_types:
        k = edge_key(et)
        out["edge_dst_starts"][k] = _dst_starts(edge_dst[k], edge_mask[k],
                                                n_nodes[et[2]])
        if src_sort:
            (out["edge_src_order"][k],
             out["edge_src_starts"][k]) = _src_sort_layout(
                edge_src[k], edge_mask[k], n_nodes[et[0]])
    for nt, (order, starts) in _dst_type_layouts(
            metadata.edge_types, edge_dst, edge_mask, n_nodes).items():
        out["dst_type_order"][nt] = order
        out["dst_type_starts"][nt] = starts
    return out


def build_kg_batch(
    node_feats: Dict[str, np.ndarray],
    edge_indices: Dict[EdgeType, np.ndarray],  # [2, E] per canonical triple
    drug_ids: Sequence[int],
    device: torch.device | str | None = None,
    src_sort: bool = False,
    sort_edges: bool = True,
) -> HeteroKGBatch:
    """Assemble a padded HeteroKGBatch on `device` (None: the card) from
    host arrays.

    Each edge type is padded to a multiple of PAD_MULTIPLE (at least one
    multiple) with masked rows, as the JAX package pads without budgets.
    sort_edges (the default) orders each edge type by destination node,
    stably (the JAX package's `sort_edges`), and adds the destination
    layouts; False keeps the input order and builds no layout (the JAX
    package's default batch, whose sums run on `index_add_`). src_sort
    adds the source-sorted layout of every edge type."""
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
        if sort_edges and ei.shape[1]:
            ei = ei[:, np.argsort(ei[1], kind="stable")]
        e = ei.shape[1]
        budget = max(-(-e // PAD_MULTIPLE), 1) * PAD_MULTIPLE
        src_np[k] = np.zeros((budget,), np.int32)
        dst_np[k] = np.zeros((budget,), np.int32)
        msk_np[k] = np.zeros((budget,), bool)
        src_np[k][:e] = ei[0]
        dst_np[k][:e] = ei[1]
        msk_np[k][:e] = True
    if sort_edges:
        layouts = kg_layouts(metadata, src_np, dst_np, msk_np, n_nodes,
                             src_sort)
    else:
        layouts = {"edge_src_order": {}, "edge_src_starts": {}}
        for et in metadata.edge_types if src_sort else ():
            k = edge_key(et)
            (layouts["edge_src_order"][k],
             layouts["edge_src_starts"][k]) = _src_sort_layout(
                src_np[k], msk_np[k], n_nodes[et[0]])

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
        **{name: put(arrays) for name, arrays in layouts.items()},
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
