"""Segment reductions over index arrays.

Port of `madrigal_tpu/ops/segment.py` on `index_add_` and
`scatter_reduce_`. As in the JAX package, rows whose segment id lies
outside [0, num_segments) are dropped: they land in one spare row that
is cut off. Segments with no members come out 0 from the sums and -inf
from `segment_max`; `segment_softmax` maps a -inf maximum to 0 so empty
and fully masked segments give zero weights, not NaN.

`group=` (a process group) is the JAX package's `axis_name`: each rank
holds a shard of the rows (the graph-parallel HGT's edges), and the
reductions merge over the group (`parallel/collectives.py`):
`segment_sum` all-reduces SUM (differentiably), `segment_max` MAX (it
carries no gradient), and `segment_softmax` takes the global maximum,
then the global denominator.
"""
from __future__ import annotations

from typing import Optional

import torch


def _safe_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids,
                       torch.full_like(ids, num_segments))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, group=None) -> torch.Tensor:
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, _safe_ids(segment_ids, num_segments), data)
    if group is None:
        return out[:num_segments]
    from ..parallel.collectives import all_reduce_sum

    return all_reduce_sum(out[:num_segments], group)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, eps: float = 0.0) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    ones = data.new_ones(data.shape[:1])
    count = segment_sum(ones, segment_ids, num_segments)
    denom = count.clamp_min(1.0) if eps == 0.0 else count + eps
    return total / denom.reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, group=None) -> torch.Tensor:
    """Per-segment maximum; empty segments come back as -inf. With a
    group, `data` must carry no gradient (the softmax detaches it)."""
    ids = _safe_ids(segment_ids, num_segments)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out.scatter_reduce_(0, idx, data, reduce="amax", include_self=True)
    if group is None:
        return out[:num_segments]
    from ..parallel.collectives import all_reduce_max

    return all_reduce_max(out[:num_segments], group)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None,
                    group=None) -> torch.Tensor:
    """Numerically stable softmax of [E, ...] logits within segments;
    masked (False) rows get zero weight. With a group, the segments span
    every rank's rows."""
    bshape = (-1,) + (1,) * (logits.dim() - 1)
    if mask is not None:
        logits = logits.masked_fill(~mask.reshape(bshape), float("-inf"))
    seg_max = segment_max(logits.detach(), segment_ids, num_segments, group)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ids = _safe_ids(segment_ids, num_segments)
    # padded ids point at the spare row: give it a zero max
    seg_max = torch.cat([seg_max, seg_max.new_zeros((1,) + seg_max.shape[1:])])
    exp = torch.exp(logits - seg_max[ids])
    if mask is not None:
        exp = exp.masked_fill(~mask.reshape(bshape), 0.0)
    denom = segment_sum(exp, segment_ids, num_segments,
                        group).clamp_min(1e-16)
    denom = torch.cat([denom, denom.new_ones((1,) + denom.shape[1:])])
    return exp / denom[ids]


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
