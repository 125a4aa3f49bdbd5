"""Segment reductions over index arrays.

Port of `madrigal_tpu/ops/segment.py`. As in the JAX package, rows whose
segment id lies outside [0, num_segments) are dropped. Segments with no
members come out 0 from the sums and -inf from `segment_max`;
`segment_softmax` maps a -inf maximum to 0 so empty and fully masked
segments give zero weights, not NaN.

The sums take an optional sorted layout: `starts`, the [N + 1] int32
boundary table of the rows grouped by segment id, and `order`, the
permutation that groups them (None when the rows are grouped already, as
a destination-sorted edge list is). It must describe `segment_ids`: the
rows in [starts[s], starts[s + 1]) of the grouped order have id s, and
the rows from starts[N] on have ids outside [0, N). With a layout,
`segment_sum` and `segment_mean` are kernel K2 (`segment_sorted.sorted_sum`,
whose backward is a gather), and `segment_softmax` takes its denominator
with K2 and gathers it back with `ops/gather.gather_rows_sorted` (whose
backward is K2): the sums have the same bits on every run, in each
segment's row order, as the JAX package's scatter on the CPU adds them.
Sums of 16-bit rows then come out f32. Without one, the sums run on
`index_add_` (`_index_add_sum`), whose CUDA form adds with atomics in an
order that changes from run to run. `segment_max` (`scatter_reduce_`
amax) needs no layout: a maximum does not depend on the order, and the
softmax detaches it.

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

from .gather import gather_rows_sorted
from .segment_sorted import sorted_sum


def _safe_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids,
                       torch.full_like(ids, num_segments))


def _index_add_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """The sums without a layout: rows with an id outside the range land
    in one spare row that is cut off."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, _safe_ids(segment_ids, num_segments), data)
    return out[:num_segments]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, group=None,
                starts: Optional[torch.Tensor] = None,
                order: Optional[torch.Tensor] = None) -> torch.Tensor:
    if starts is not None:
        out = sorted_sum(data, starts, order)
    else:
        out = _index_add_sum(data, segment_ids, num_segments)
    if group is None:
        return out
    from ..parallel.collectives import all_reduce_sum

    return all_reduce_sum(out, group)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, eps: float = 0.0,
                 starts: Optional[torch.Tensor] = None,
                 order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment sums over member counts; with a layout the counts are the
    spans' lengths, so only the sums run K2."""
    total = segment_sum(data, segment_ids, num_segments, starts=starts,
                        order=order)
    if starts is not None:
        count = (starts[1:] - starts[:-1]).to(total.dtype)
    else:
        count = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                            num_segments)
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
                    group=None, starts: Optional[torch.Tensor] = None,
                    order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax of [E, ...] logits within segments;
    masked (False) rows get zero weight. With a group, the segments span
    every rank's rows. With a layout (module docstring), masked rows must
    lie outside every span."""
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
    denom = segment_sum(exp, segment_ids, num_segments, group, starts,
                        order).clamp_min(1e-16)
    denom = torch.cat([denom, denom.new_ones((1,) + denom.shape[1:])])
    if starts is None:
        return exp / denom[ids]
    return exp / gather_rows_sorted(denom, ids, order, starts)


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
