"""Label-sharded all-pairs scores and ranks, dp-sharded drug embedding
(port of `madrigal_tpu/parallel/allpairs.py`).

Every outcome's [N, N] score-and-rank job is independent, so the outcome
(label) axis splits over the mesh's last axis: each rank holds the
replicated [N, D] embedding table and scores and ranks its own outcomes
with kernel K1 (`eval/ranks.normalized_ranks_for_outcomes`,
`ops/bilinear.bilinear_scores`) with no communication until its blocks
leave. The rank tensor's blocks are gathered on the label group's first
rank, which writes the host `out` (np.memmap-compatible): so one rank
writes every file, on one host. With gloo (ranks sharing one card) each
rank copies its blocks to the host first, where they are going anyway,
and gloo gathers host tensors (NCCL gathers them card to card).

Embedding the drugs splits the drug batches over 'dp' instead
(`embed_all_drugs_sharded`).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import copy_to_host
from ..eval.ranks import normalized_ranks_for_outcomes
from ..ops.bilinear import bilinear_scores
from .collectives import all_gather_object, all_gather_tensor, backend
from .collectives import broadcast_tensors, gather_tensors
from .mesh import axis_group, axis_rank, axis_size, pad_to_multiple
from .multihost import rank_device


def _label_axis(mesh) -> str:
    return mesh.mesh_dim_names[-1]


def sharded_rank_tensor(mesh, z, w_sym, chunk_per_device: int = 4,
                        compute_dtype: torch.dtype = torch.float32,
                        out: Optional[np.ndarray] = None
                        ) -> Optional[np.ndarray]:
    """Full [L, N, N] normalized-rank tensor computed label-sharded over
    the mesh's last axis, d ranks.

    Blocks of d * chunk_per_device outcomes (the last one padded with
    zero weights to a multiple of d) are split into d contiguous parts,
    one a rank; each rank ranks its part through K1 and the ranks are
    gathered on the label group's first rank, which writes them into
    `out` (allocated there when None) and returns it. Other ranks return
    None. The float32 default gives eval.ranks.rank_tensor's ranks
    exactly: each outcome's scores and ranks do not depend on the block
    it falls in. Every rank ranks the first rank's `z` (it is broadcast,
    one [N, 128] table): the ranks' own embeddings have the same bits
    when they come from the same pass (every encoder sum runs on K2 in a
    fixed order), and the broadcast keeps the export one table's when a
    caller hands the ranks tables made otherwise, where near-tied scores
    would swap ranks between the ranks' outcomes."""
    axis = _label_axis(mesh)
    group = axis_group(axis, mesh)
    d, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    dev = rank_device()
    zd = torch.as_tensor(np.asarray(z, np.float32)).to(dev)
    broadcast_tensors([zd], group)
    w_sym = np.asarray(w_sym, np.float32)
    L, n = w_sym.shape[0], zd.shape[0]
    first = r == 0
    if first and out is None:
        out = np.empty((L, n, n), dtype=np.float32)
    staged = backend(group) == "gloo" and dev.type == "cuda"
    block = d * chunk_per_device
    for s in range(0, L, block):
        e = min(s + block, L)
        w_blk, _ = pad_to_multiple(w_sym[s:e], d, axis=0)
        per = w_blk.shape[0] // d
        w_mine = torch.from_numpy(w_blk[r * per:(r + 1) * per]).to(dev)
        ranks = normalized_ranks_for_outcomes(zd, w_mine, compute_dtype)
        if staged:  # bound for the host: gloo sends them from there
            ranks = ranks.cpu()
        parts = gather_tensors(ranks, group)
        for i, part in enumerate(parts or ()):  # the first rank's
            lo = s + i * per
            if lo < e:
                copy_to_host(out[lo:min(lo + per, e)], part[:e - lo])
    return out if first else None


def sharded_score_chunk(mesh, z_head: torch.Tensor, z_tail: torch.Tensor,
                        w_sym_chunk: torch.Tensor,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """[Lc, N_head, N_tail] raw scores, label-sharded (the
    `get_*_scores_for_all_pairs` analog, predict.py:419-429): each rank
    scores its contiguous part of the outcomes through K1 (float32 out),
    and every rank gets the whole chunk back, on its device. The first
    rank's embeddings are broadcast, as in sharded_rank_tensor."""
    axis = _label_axis(mesh)
    group = axis_group(axis, mesh)
    d, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    dev = rank_device()
    z_head = z_head.to(dev, torch.float32, copy=True)
    z_tail = z_tail.to(dev, torch.float32, copy=True)
    broadcast_tensors([z_head, z_tail], group)
    Lc = w_sym_chunk.shape[0]
    per = -(-Lc // d)
    w = w_sym_chunk.to(dev, torch.float32)
    w_mine = w[r * per:(r + 1) * per]
    if w_mine.shape[0] < per:  # the last parts are padded with zeros
        w_mine = torch.cat([w_mine, w.new_zeros(
            (per - w_mine.shape[0],) + tuple(w.shape[1:]))])
    mine = bilinear_scores(z_head, z_tail,
                           w_mine.contiguous(), out_dtype=torch.float32,
                           compute_dtype=compute_dtype)
    return all_gather_tensor(mine, group)[:Lc]


def embed_all_drugs_sharded(mesh, encoder_apply: Callable,
                            batches: Sequence) -> np.ndarray:
    """Embed drug batches data-parallel over the mesh's 'dp' axis (its
    first axis when it has none): batch i runs on the rank at dp
    coordinate i mod dp, through `encoder_apply(batch) -> [B, D]`, and
    every rank gets all the rows back, in batch order, as one array.
    The weights are replicated; no rank waits on another until the
    gather. Unlike the JAX package, batches need not share a shape."""
    axis = "dp" if "dp" in mesh.mesh_dim_names else mesh.mesh_dim_names[0]
    dp, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    mine = {}
    with torch.no_grad():
        for i in range(r, len(batches), dp):
            mine[i] = encoder_apply(batches[i]).cpu().numpy()
    parts = {}
    for got in all_gather_object(mine, axis_group(axis, mesh)):
        parts.update(got)
    return np.concatenate([parts[i] for i in range(len(batches))], axis=0)
