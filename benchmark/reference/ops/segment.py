"""Segment reductions over index arrays, plain PyTorch (a frozen copy of
the port's `ops/segment.py` with its sorted sums taken out).

Rows whose segment id lies outside [0, num_segments) are dropped.
Segments with no members come out 0 from the sums and -inf from
`segment_max`; `segment_softmax` maps a -inf maximum to 0, so empty and
fully masked segments give zero weights. Every sum accumulates in
float64 (`sum64`) and is rounded once to the rows' type, so it is the
exact sum rounded, whatever order the device's atomic adds take. Each
gather whose transpose the port sums on kernel K2 is `gather_rows`,
whose backward is the same float64 sum.
"""
from __future__ import annotations

from typing import Optional

import torch


def _safe_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids,
                       torch.full_like(ids, num_segments))


SUM64_ROWS = 1 << 20  # rows widened to float64 at a time


def sum64(data: torch.Tensor, ids: torch.Tensor, num_rows: int
          ) -> torch.Tensor:
    """out[i] = the sum of data[j] over ids[j] == i, each id in [0,
    num_rows), accumulated in float64 by `index_add_` on blocks of rows
    and rounded once to data's type: a float32 sum of fewer than 2**29
    rows is then the exact sum rounded, up to a float64 tie, in any order
    of the adds. No gradient."""
    out = torch.zeros((num_rows,) + tuple(data.shape[1:]),
                      dtype=torch.float64, device=data.device)
    with torch.no_grad():
        for a in range(0, data.shape[0], SUM64_ROWS):
            out.index_add_(0, ids[a:a + SUM64_ROWS],
                           data[a:a + SUM64_ROWS].double())
    return out.to(data.dtype)


class _SegmentSum(torch.autograd.Function):
    """`sum64` into num_segments + 1 rows (the last the spare row of the
    ids outside the range); its transpose is the gather of the output's
    cotangent, exact."""

    @staticmethod
    def forward(ctx, data, ids, num_rows):
        ctx.save_for_backward(ids)
        return sum64(data, ids, num_rows)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad[ids], None, None


class _Gather(torch.autograd.Function):
    """`table[idx]`, whose transpose is `sum64` of the cotangent's rows."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return sum64(grad, idx, ctx.rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]` with the float64 transpose: every gather of the
    reference that the port runs with a K2 backward goes through it."""
    return _Gather.apply(table, idx.long())


def _index_add_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """The sums: rows with an id outside the range land in one spare row
    that is cut off."""
    out = _SegmentSum.apply(data, _safe_ids(segment_ids, num_segments),
                            num_segments + 1)
    return out[:num_segments]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _index_add_sum(data, segment_ids, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, eps: float = 0.0) -> torch.Tensor:
    """Segment sums over member counts."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                        num_segments)
    denom = count.clamp_min(1.0) if eps == 0.0 else count + eps
    return total / denom.reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment maximum; empty segments come back as -inf."""
    ids = _safe_ids(segment_ids, num_segments)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out.scatter_reduce_(0, idx, data, reduce="amax", include_self=True)
    return out[:num_segments]


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax of [E, ...] logits within segments;
    masked (False) rows get zero weight."""
    bshape = (-1,) + (1,) * (logits.dim() - 1)
    if mask is not None:
        logits = logits.masked_fill(~mask.reshape(bshape), float("-inf"))
    seg_max = segment_max(logits.detach(), segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ids = _safe_ids(segment_ids, num_segments)
    # padded ids point at the spare row: give it a zero max
    seg_max = torch.cat([seg_max, seg_max.new_zeros((1,) + seg_max.shape[1:])])
    exp = torch.exp(logits - seg_max[ids])
    if mask is not None:
        exp = exp.masked_fill(~mask.reshape(bshape), 0.0)
    denom = segment_sum(exp, segment_ids, num_segments).clamp_min(1e-16)
    denom = torch.cat([denom, denom.new_ones((1,) + denom.shape[1:])])
    return exp / _Gather.apply(denom, ids)


def masked_mean_pool(tokens: torch.Tensor, keep_mask: torch.Tensor,
                     dim: int = 1) -> torch.Tensor:
    """Mean over `dim` of [..., T, D] tokens restricted to keep_mask
    (True = keep)."""
    m = keep_mask.to(tokens.dtype).unsqueeze(-1)
    total = (tokens * m).sum(dim)
    count = m.sum(dim).clamp_min(1.0)
    return total / count


def masked_max_pool(tokens: torch.Tensor, keep_mask: torch.Tensor,
                    dim: int = 1) -> torch.Tensor:
    """Max over `dim` restricted to keep_mask; empty selections give 0."""
    masked = tokens.masked_fill(~keep_mask.unsqueeze(-1), float("-inf"))
    out = masked.amax(dim)
    any_kept = keep_mask.any(dim).unsqueeze(-1)
    return torch.where(any_kept, out, torch.zeros_like(out))
