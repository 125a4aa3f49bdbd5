"""Row gather with a sorted segment-sum backward (port of
`madrigal_tpu/ops/gather.py::gather_rows_mxu`).

`gather_rows_sorted(table, idx, order, starts)` is `table[idx]`. Its
backward permutes the cotangent rows into source-sorted order
(`cot[order]`) and reduces each source's span with kernel K2
(`ops/segment_sorted.py`): a plain `table[idx]` would instead leave the
transpose to `index_add_`, whose CUDA form adds rows with atomics in an
order that changes from run to run.

The JAX package's other variant, `gather_rows` (a degree-chunked arena
with per-source run padding), is a measured negative result on the TPU
and is not ported.
"""
from __future__ import annotations

import torch

from .segment_sorted import sorted_segment_sum


class GatherRowsSorted(torch.autograd.Function):
    """table [N, W], idx [E] int, order [E] int32 (a permutation of the
    edge axis sorted by idx, real edges first), starts [N + 1] int32 (the
    boundary table over that order; starts[N] = number of real edges, so
    the rows of masked edges, whose cotangents are zero, never enter)."""

    @staticmethod
    def forward(ctx, table, idx, order, starts):
        ctx.save_for_backward(order, starts)
        ctx.num_rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, cot):
        order, starts = ctx.saved_tensors
        grad = sorted_segment_sum(cot.index_select(0, order), starts,
                                  ctx.num_rows)
        return grad.to(cot.dtype), None, None, None


def gather_rows_sorted(table: torch.Tensor, idx: torch.Tensor,
                       order: torch.Tensor, starts: torch.Tensor
                       ) -> torch.Tensor:
    """`table[idx]` whose backward is a sorted segment sum (K2)."""
    return GatherRowsSorted.apply(table, idx, order, starts)
