"""Row gather with a sorted segment-sum backward (port of
`madrigal_tpu/ops/gather.py::gather_rows_mxu`).

`gather_rows_sorted(table, idx, order, starts)` is `table[idx]`. Its
backward groups the cotangent rows by index (`cot[order]`, or the rows as
they are when `idx` is already sorted and `order` is None) and reduces
each index's span with kernel K2 (`ops/segment_sorted.py`), in ascending
row order, so the gradient has the same bits on every run. A plain
`table[idx]` leaves the transpose to PyTorch's accumulating scatter
instead.

`gather_rows_grouped(table, idx)` builds that layout on the device (a
stable sort of `idx`) for index arrays that come with none, as an
embedding lookup's: its backward is K2 too, where `nn.Embedding`'s CUDA
backward does not repeat from run to run.

The JAX package's other variant, `gather_rows` (a degree-chunked arena
with per-source run padding), is a measured negative result on the TPU
and is not ported.
"""
from __future__ import annotations

import torch

from .segment_sorted import sorted_segment_sum


class GatherRowsSorted(torch.autograd.Function):
    """table [T, ...], idx [E] int, order [E] int32 or None (a permutation
    of the edge axis sorted by idx, real edges first; None when idx is
    sorted already), starts [N + 1] int32 (the boundary table over that
    order, N <= T; starts[N] = number of real edges, so the rows of masked
    edges, whose cotangents are zero, never enter). Table rows at or past
    N (a spare row for padded indices) get a zero gradient."""

    @staticmethod
    def forward(ctx, table, idx, order, starts):
        ctx.save_for_backward(order, starts)
        ctx.table_shape = table.shape
        return table[idx.long()]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cot):
        order, starts = ctx.saved_tensors
        n = starts.shape[0] - 1
        rows = cot.reshape(cot.shape[0], -1)
        if order is not None:
            rows = rows.index_select(0, order)
        grad = sorted_segment_sum(rows.contiguous(), starts, n).to(cot.dtype)
        spare = ctx.table_shape[0] - n
        if spare:
            grad = torch.cat([grad, grad.new_zeros((spare, grad.shape[1]))])
        return grad.reshape(ctx.table_shape), None, None, None


def gather_rows_sorted(table: torch.Tensor, idx: torch.Tensor,
                       order: torch.Tensor | None, starts: torch.Tensor
                       ) -> torch.Tensor:
    """`table[idx]` whose backward is a sorted segment sum (K2)."""
    return GatherRowsSorted.apply(table, idx, order, starts)


def gather_rows_grouped(table: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """`table[idx]` for indices in [0, len(table)), its backward K2 over the
    layout of a stable sort of `idx` (made at each call: for short index
    arrays)."""
    ids, order = torch.sort(idx.long(), stable=True)
    starts = torch.searchsorted(
        ids, torch.arange(table.shape[0] + 1, device=idx.device))
    return gather_rows_sorted(table, idx, order.to(torch.int32),
                              starts.to(torch.int32))
