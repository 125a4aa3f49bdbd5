"""Drug-rooted KG subgraph sampling (a copy of
`madrigal_tpu/data/kg_sampling.py`, numpy only; the subgraph is built by
the port's `data/kg.build_kg_batch`, which pads each edge type to a
multiple of PAD_MULTIPLE, 512, where the JAX function passes 256).

Host-side equivalent of the reference's NeighborLoader-based sampling
(reference: madrigal/data/data_utils.py:296-337 sample_kg_data): seed the
frontier with the batch's drug nodes, expand `num_layers` hops taking up to
`num_neighbors` incoming edges per node per edge type, and relabel into a
compact padded subgraph. The reference's DEFAULT path is NO sampling (full
KG clone, data_utils.py:330-332); sampling exists for memory-constrained
regimes, and on TPU also stabilizes shapes via fixed per-edge-type budgets.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .kg import EdgeType, HeteroKGBatch, build_kg_batch


def sample_kg_subgraph(
    node_feats: Dict[str, np.ndarray],
    edge_indices: Dict[EdgeType, np.ndarray],
    kg_drug_ids: np.ndarray,
    seed_drug_rows: Sequence[int],
    num_neighbors: int,
    num_layers: int,
    rng: Optional[np.random.RandomState] = None,
    device: torch.device | str | None = None,
    src_sort: bool = False,
) -> Tuple[HeteroKGBatch, np.ndarray]:
    """Returns (subgraph batch, drug_row_map) where drug_row_map[i] is the
    row in the SUBGRAPH's drug table for original drug row i (-1 if
    dropped). The subgraph's drug_index_map keeps global drug ids so
    `drug_row_lookup` composes unchanged. The batch lands on `device`
    (None: the card), with the source-sorted layout under `src_sort`.
    """
    rng = rng or np.random.RandomState(0)

    # incoming-edge adjacency per edge type, grouped by dst
    incoming: Dict[EdgeType, Dict[int, np.ndarray]] = {}
    for et, ei in edge_indices.items():
        ei = np.asarray(ei)
        order = np.argsort(ei[1], kind="stable")
        dsts, starts = np.unique(ei[1][order], return_index=True)
        groups = np.split(order, starts[1:])
        incoming[et] = {int(d): g for d, g in zip(dsts, groups)}

    keep: Dict[str, set] = {nt: set() for nt in node_feats}
    keep["drug"].update(int(r) for r in seed_drug_rows)
    chosen_edges: Dict[EdgeType, list] = {et: [] for et in edge_indices}

    frontier: Dict[str, set] = {nt: set() for nt in node_feats}
    frontier["drug"].update(keep["drug"])
    for _ in range(num_layers):
        new_frontier: Dict[str, set] = {nt: set() for nt in node_feats}
        for et, ei in edge_indices.items():
            src_t, _, dst_t = et
            ei = np.asarray(ei)
            for node in frontier[dst_t]:
                g = incoming[et].get(node)
                if g is None:
                    continue
                if len(g) > num_neighbors:
                    g = rng.choice(g, num_neighbors, replace=False)
                chosen_edges[et].extend(g.tolist())
                for s in ei[0][g]:
                    s = int(s)
                    if s not in keep[src_t]:
                        new_frontier[src_t].add(s)
        for nt in node_feats:
            keep[nt].update(new_frontier[nt])
        frontier = new_frontier

    # relabel
    relabel: Dict[str, Dict[int, int]] = {}
    sub_feats: Dict[str, np.ndarray] = {}
    for nt, nodes in keep.items():
        rows = np.asarray(sorted(nodes), dtype=np.int64)
        relabel[nt] = {int(r): i for i, r in enumerate(rows)}
        sub_feats[nt] = (
            node_feats[nt][rows] if len(rows)
            else np.zeros((1, node_feats[nt].shape[1]), np.float32)
        )
        if not len(rows):
            relabel[nt] = {}

    sub_edges: Dict[EdgeType, np.ndarray] = {}
    for et, idxs in chosen_edges.items():
        src_t, _, dst_t = et
        ei = np.asarray(edge_indices[et])
        if not idxs:
            sub_edges[et] = np.zeros((2, 0), np.int64)
            continue
        idxs = np.unique(np.asarray(idxs))
        src = ei[0][idxs]
        dst = ei[1][idxs]
        ok = np.array([
            s in relabel[src_t] and d in relabel[dst_t]
            for s, d in zip(src, dst)
        ])
        src = np.asarray([relabel[src_t][int(s)] for s in src[ok]])
        dst = np.asarray([relabel[dst_t][int(d)] for d in dst[ok]])
        sub_edges[et] = np.stack([src, dst]) if len(src) else \
            np.zeros((2, 0), np.int64)

    drug_rows = np.asarray(sorted(keep["drug"]), dtype=np.int64)
    sub_drug_ids = np.asarray(kg_drug_ids)[drug_rows]
    drug_row_map = np.full(len(kg_drug_ids), -1, np.int64)
    drug_row_map[drug_rows] = np.arange(len(drug_rows))

    batch = build_kg_batch(
        sub_feats, sub_edges, sub_drug_ids, device=device, src_sort=src_sort
    )
    return batch, drug_row_map
