"""Padded molecular graph batches as tensors.

Port of `madrigal_tpu/data/molgraph.py`: molecules are packed into one
node/edge arena padded to a multiple of 128 rows, as the JAX package pads
without budgets, so the arrays equal its own. The padding is not needed
by PyTorch, but keeping it makes the two batches comparable array for
array. Beside those arrays the batch carries the sorted layouts that
kernel K2 sums over (`ops/segment.py`, `ops/gather.py`): the bonds
grouped by destination and by source atom, and the atoms' graph
boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import BOND_DIM, MOL_DIM
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class MolGraphBatch:
    """A batch of molecules packed into a single padded arena.

    node_feats [N_pad, MOL_DIM] f32; node_mask [N_pad] bool; node_graph
    [N_pad] int32 graph id per atom (padding rows hold `num_graphs`);
    edge_src/edge_dst [E_pad] int32 (bonds in both directions, padding 0);
    edge_feats [E_pad, BOND_DIM] f32; edge_mask [E_pad] bool.

    The K2 layouts (None when not built): edge_dst_order / edge_src_order
    [E_pad] int32, the bonds sorted stably by destination / source atom,
    real bonds first (a bond stays in its molecule's node block, so each
    order permutes within a block); edge_dst_starts / edge_src_starts
    [N_pad + 1] int32, the boundary tables over those orders
    (starts[N_pad] = number of real bonds); node_graph_starts
    [num_graphs + 1] int32, the first atom of each graph (atoms are packed
    by graph, padding last, so the readout needs no order).
    """

    node_feats: torch.Tensor
    node_mask: torch.Tensor
    node_graph: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_feats: torch.Tensor
    edge_mask: torch.Tensor
    num_graphs: int
    edge_dst_order: Optional[torch.Tensor] = None
    edge_dst_starts: Optional[torch.Tensor] = None
    edge_src_order: Optional[torch.Tensor] = None
    edge_src_starts: Optional[torch.Tensor] = None
    node_graph_starts: Optional[torch.Tensor] = None

    @property
    def num_nodes_padded(self) -> int:
        return self.node_feats.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.edge_src.shape[0]


PAD_MULTIPLE = 128


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def _sort_layout(ids: np.ndarray, msk: np.ndarray, n: int):
    """(order, [n + 1] starts) of the real rows sorted stably by id, the
    masked rows last."""
    order = np.argsort(np.where(msk, ids.astype(np.int64), np.int64(n) + 1),
                       kind="stable").astype(np.int32)
    n_real = int(msk.sum())
    return order, np.searchsorted(ids[order[:n_real]],
                                  np.arange(n + 1)).astype(np.int32)


def mol_layouts(node_mask: np.ndarray, node_graph: np.ndarray,
                edge_src: np.ndarray, edge_dst: np.ndarray,
                edge_mask: np.ndarray, num_graphs: int) -> dict:
    """MolGraphBatch's K2 layout fields (numpy) of a packed arena whose
    real atoms come first, grouped by graph."""
    n_pad = node_mask.shape[0]
    n_real = int(node_mask.sum())
    if not node_mask[:n_real].all():
        raise ValueError("the real atoms are not the leading rows")
    out = {}
    for side, ids in (("dst", edge_dst), ("src", edge_src)):
        out[f"edge_{side}_order"], out[f"edge_{side}_starts"] = _sort_layout(
            ids, edge_mask, n_pad)
    out["node_graph_starts"] = np.searchsorted(
        node_graph[:n_real], np.arange(num_graphs + 1)).astype(np.int32)
    return out


def pack_molecules(
    graphs: Sequence[dict],
    device: torch.device | str | None = None,
) -> MolGraphBatch:
    """Pack per-molecule dicts ('node_feats' [n, MOL_DIM], 'edge_index'
    [e, 2], 'edge_feats' [e, BOND_DIM]) into one padded MolGraphBatch on
    `device` (None: the card)."""
    device = resolve_device(device)
    n_total = sum(int(g["node_feats"].shape[0]) for g in graphs)
    e_total = sum(int(g["edge_index"].shape[0]) for g in graphs)
    n_pad = round_up(max(n_total, 1), PAD_MULTIPLE)
    e_pad = round_up(max(e_total, 1), PAD_MULTIPLE)

    node_feats = np.zeros((n_pad, MOL_DIM), dtype=np.float32)
    node_mask = np.zeros((n_pad,), dtype=bool)
    node_graph = np.full((n_pad,), len(graphs), dtype=np.int32)
    edge_src = np.zeros((e_pad,), dtype=np.int32)
    edge_dst = np.zeros((e_pad,), dtype=np.int32)
    edge_feats = np.zeros((e_pad, BOND_DIM), dtype=np.float32)
    edge_mask = np.zeros((e_pad,), dtype=bool)

    n_off = 0
    e_off = 0
    for gid, g in enumerate(graphs):
        n = int(g["node_feats"].shape[0])
        e = int(g["edge_index"].shape[0])
        node_feats[n_off : n_off + n] = g["node_feats"]
        node_mask[n_off : n_off + n] = True
        node_graph[n_off : n_off + n] = gid
        if e:
            ei = np.asarray(g["edge_index"], dtype=np.int32)
            edge_src[e_off : e_off + e] = ei[:, 0] + n_off
            edge_dst[e_off : e_off + e] = ei[:, 1] + n_off
            edge_feats[e_off : e_off + e] = g["edge_feats"]
            edge_mask[e_off : e_off + e] = True
        n_off += n
        e_off += e

    def t(x):
        return torch.from_numpy(x).to(device)

    layouts = mol_layouts(node_mask, node_graph, edge_src, edge_dst,
                          edge_mask, len(graphs))
    return MolGraphBatch(
        node_feats=t(node_feats),
        node_mask=t(node_mask),
        node_graph=t(node_graph),
        edge_src=t(edge_src),
        edge_dst=t(edge_dst),
        edge_feats=t(edge_feats),
        edge_mask=t(edge_mask),
        num_graphs=len(graphs),
        **{k: t(v) for k, v in layouts.items()},
    )
