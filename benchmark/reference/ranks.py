"""Normalized ranks, plain PyTorch (reference notebooks/normalize_scores.py
and the JAX package's compiled rank formula).

For one outcome, the scores are z @ W_l @ z^T in float32; the entries of
the strict lower triangle, taken row by row, are ranked by a sort (stable:
equal scores keep that order), and rank r (1-based) is written as
float32(r) times float32(1) / float32(m), m = n(n - 1) / 2. The full
matrix holds each rank at (i, j) and (j, i), and 0 on the diagonal.
"""
from __future__ import annotations

import torch


def inverse_count(m: int, device) -> torch.Tensor:
    """float32(1) / float32(m)."""
    return (torch.tensor(1.0, dtype=torch.float32, device=device)
            / torch.tensor(float(m), dtype=torch.float32, device=device))


def rank_values(m: int, device) -> torch.Tensor:
    """[m] the normalized ranks 1..m, ascending, as float32."""
    pos = torch.arange(m, device=device).to(torch.float32) + 1.0
    return pos * inverse_count(m, device)


@torch.no_grad()
def lower_tri_ranks(z: torch.Tensor, w_l: torch.Tensor,
                    stable: bool = True) -> torch.Tensor:
    """[m] the normalized ranks of one outcome's strict lower triangle,
    row-major."""
    n = z.shape[0]
    scores = torch.matmul(torch.matmul(z, w_l), z.T)
    rows, cols = torch.tril_indices(n, n, -1, device=z.device)
    vals = scores[rows, cols]
    del scores
    order = torch.sort(vals, stable=stable)[1]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(vals.shape[0], device=z.device)
    return (pos.to(torch.float32) + 1.0) * inverse_count(vals.shape[0],
                                                         z.device)
