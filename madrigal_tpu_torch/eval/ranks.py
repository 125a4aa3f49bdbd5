"""All-pairs normalized ranks (port of `madrigal_tpu/eval/ranks.py`;
reference notebooks/normalize_scores.py:36-90).

Per outcome, the [N, N] score matrix's strict lower triangle is ranked
(the reference's double argsort), divided by m = N(N-1)/2, zeroed on the
upper triangle and the diagonal, and symmetrized by adding the transpose.
The scores come from kernel K1 (`ops/bilinear.py::bilinear_scores`, as
every serving score does); the ranks from one `torch.sort` and a scatter
that inverts its permutation (a permutation has one inverse, so this is
the JAX package's second sort).

The JAX package sorts all N^2 entries, with the upper triangle set to
+inf. For finite scores every +inf ranks after every score, so the port
sorts only the m entries of the strict lower triangle, in the order the
JAX package's sort would meet them: row-major, or, with `compact`, the
order of its tri-tile packing (blocks of 128 x 128 that meet the lower
triangle, row-major within a block). Under ties a stable sort ranks equal
scores by that order, so every (stable, compact) pair gives the JAX
package's ranks; with distinct scores all give the same. The tile packing
itself and the u32 sort keys are TPU layout work with no counterpart.

The ranks are float32 as in the JAX package's compiled rank paths
(`rank_tensor`, `normalized_ranks_for_outcomes`,
`normalized_rank_matrices`, all under jit): float32(position) + 1, times
float32(1) / float32(m). XLA rewrites the source's division by the
constant m into that product; the product and the division differ by one
unit in the last place on some entries, and the JAX function called
outside jit divides. Above N of about 5,794, m and the largest ranks pass
2^24 and round as the JAX package's do.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import copy_to_host, resolve_device
from ..ops.bilinear import bilinear_scores
from ..utils.profiling import span

TILE = 128  # the JAX package's tri-tile packing block


def lower_tri_order(n: int, compact: bool, device) -> torch.Tensor:
    """Flat indices [m] of the strict lower triangle of an [n, n] matrix:
    row-major, or in the JAX package's tri-tile packing order."""
    if not compact:
        rows, cols = torch.tril_indices(n, n, -1, device=device)
        return rows * n + cols
    T = -(-n // TILE)
    ti, tj = torch.tril_indices(T, T, 0, device=device)  # kept blocks
    r = torch.arange(TILE, device=device)
    rows = ti[:, None, None] * TILE + r[None, :, None]
    cols = tj[:, None, None] * TILE + r[None, None, :]
    return (rows * n + cols)[(rows > cols) & (rows < n)]


def inv_count(m: int, device) -> torch.Tensor:
    """float32(1) / float32(m), a 0-d float32 tensor on `device`."""
    return (torch.tensor(1.0, dtype=torch.float32)
            / torch.tensor(float(m), dtype=torch.float32)).to(device)


def rank_lower(scores: torch.Tensor, order_idx: torch.Tensor,
                stable: bool) -> torch.Tensor:
    """The normalized-rank matrix of `scores` [n, n], ranking the entries
    at `order_idx` (from lower_tri_order) in that order."""
    n = scores.shape[0]
    m = order_idx.shape[0]
    dev = scores.device
    vals = scores.reshape(-1).index_select(0, order_idx)
    order = torch.argsort(vals, stable=stable)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(m, device=dev))
    # times float32(1 / float32(m)): XLA compiles the JAX package's
    # division by the constant m into this product, in every jitted path
    ranks = (inv.to(torch.float32) + 1.0) * inv_count(m, dev)
    out = torch.zeros(n * n, dtype=torch.float32, device=dev).scatter_(
        0, order_idx, ranks).view(n, n)
    return out + out.T


def normalized_rank_matrix(scores: torch.Tensor, stable: bool = True,
                           compact: Optional[bool] = None) -> torch.Tensor:
    """Rank-normalize one outcome's [N, N] score matrix, on its device.

    Entry (i, j), i != j, holds rank(score[max(i,j), min(i,j)]) /
    (N(N-1)/2); the diagonal is 0. compact (default: on exactly when
    stable=False) ranks ties in the JAX package's tri-tile order, not in
    row-major order; for distinct scores neither flag changes anything."""
    if compact is None:
        compact = not stable
    return rank_lower(scores, lower_tri_order(scores.shape[0], compact,
                                               scores.device), stable)


def score_outcome(z: torch.Tensor, w_sym_l: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[N, N] bilinear scores for one outcome, z @ W_l @ z.T, through K1
    (the kernel on CUDA tensors, its plain version on the CPU), with
    `dtype` compute and f32 accumulation."""
    return bilinear_scores(z, z, w_sym_l[None].contiguous(),
                           out_dtype=torch.float32, compute_dtype=dtype)[0]


@torch.no_grad()
def normalized_ranks_for_outcomes(
    z: torch.Tensor, w_sym: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32, stable: bool = True,
) -> torch.Tensor:
    """[Lc, N, N] normalized ranks for a chunk of outcomes: one K1 call
    for the chunk's scores, then each outcome ranked in turn into its own
    slot, so the peak is the chunk's scores plus one outcome's sort
    buffers."""
    out = bilinear_scores(z, z, w_sym.contiguous(), out_dtype=torch.float32,
                          compute_dtype=compute_dtype)
    with span("madrigal.rank_sort"):
        order_idx = lower_tri_order(z.shape[0], not stable, z.device)
        for l in range(out.shape[0]):
            out[l] = rank_lower(out[l], order_idx, stable)
    return out


def rank_tensor(
    z,
    w_sym,
    chunk: int = 8,
    compute_dtype: torch.dtype = torch.float32,
    out: Optional[np.ndarray] = None,
    stable: bool = True,
    device=None,
) -> np.ndarray:
    """Full [L, N, N] normalized-rank tensor computed on `device` (None:
    the card), streamed to the host a chunk of outcomes at a time (pass an
    np.memmap as `out` for the reference-format artifact)."""
    dev = resolve_device(device)
    zd = torch.as_tensor(np.asarray(z, np.float32)).to(dev)
    wd = torch.as_tensor(w_sym).to(device=dev, dtype=torch.float32)
    L, n = wd.shape[0], zd.shape[0]
    if out is None:
        out = np.empty((L, n, n), dtype=np.float32)
    for s in range(0, L, chunk):
        e = min(s + chunk, L)
        block = normalized_ranks_for_outcomes(zd, wd[s:e], compute_dtype,
                                              stable=stable)
        copy_to_host(out[s:e], block)
    return out


@torch.no_grad()
def normalized_rank_matrices(mats: torch.Tensor,
                             stable: bool = True) -> torch.Tensor:
    """Re-rank a chunk of [Lc, N, N] matrices on their device; only the
    strict lower triangle is read."""
    order_idx = lower_tri_order(mats.shape[1], not stable, mats.device)
    return torch.stack([rank_lower(m, order_idx, stable) for m in mats])


def ensemble_normalized_ranks(rank_tensors, out: Optional[np.ndarray] = None,
                              chunk: int = 8, stable: bool = True,
                              device=None) -> np.ndarray:
    """Multi-seed ensembling (reference generate_embeddings.ipynb cells
    18-20, predict.py:466-499): geometric mean of normalized ranks across
    seed checkpoints on the host (scipy), then a re-rank on `device`
    (None: the card) of its float32 rounding, as the JAX package does.

    Streams outcome chunks, so `rank_tensors` may be np.memmaps of the
    [L, N, N] artifacts and `out` a w+ memmap. Upper-triangle and diagonal
    entries are 0 in every seed, so their gmean is 0, and the re-rank's
    lower-triangle read plus symmetrization gives the reference layout.
    """
    from scipy.stats import gmean

    dev = resolve_device(device)
    L, n, _ = rank_tensors[0].shape
    if out is None:
        out = np.empty((L, n, n), dtype=np.float32)
    for s in range(0, L, chunk):
        e = min(s + chunk, L)
        stacked = np.stack([np.asarray(r[s:e]) for r in rank_tensors])
        with np.errstate(divide="ignore"):  # log(0) off the lower triangle
            g = np.asarray(gmean(stacked, axis=0), np.float32)
        copy_to_host(out[s:e], normalized_rank_matrices(
            torch.from_numpy(g).to(dev), stable=stable))
    return out


def normalize_scores_offline(
    raw_scores_path: str,
    out_path: str,
    num_workers: Optional[int] = None,
):
    """Reference-compatible offline CPU rank normalization over an
    [L, N, N] raw-score .npy: a process pool over outcome slices into a
    memmap (reference: notebooks/normalize_scores.py:29-90), in float64.
    Provided for artifact-format parity on machines without a card; the
    workers start by spawning, not forking this process."""
    import multiprocessing as mp

    raw = np.load(raw_scores_path, mmap_mode="r")
    L, n, _ = raw.shape
    out = np.lib.format.open_memmap(
        out_path, mode="w+", dtype=np.float32, shape=(L, n, n)
    )
    del out  # workers re-open

    args = [(raw_scores_path, out_path, l) for l in range(L)]
    with mp.get_context("spawn").Pool(num_workers) as pool:
        pool.map(_offline_slice, args)
    return np.load(out_path, mmap_mode="r")


def _offline_slice(arg):
    raw_path, out_path, l = arg
    raw = np.load(raw_path, mmap_mode="r")
    out = np.lib.format.open_memmap(out_path, mode="r+")
    n = raw.shape[1]
    m = n * (n - 1) / 2
    s = np.array(raw[l], dtype=np.float64)
    iu = np.triu_indices(n, k=0)
    s[iu] = np.inf
    flat = s.reshape(-1)
    rank = flat.argsort(kind="stable").argsort(kind="stable") + 1
    norm = (rank / m).reshape(n, n).astype(np.float32)
    norm[iu] = 0.0
    out[l] = norm + norm.T
