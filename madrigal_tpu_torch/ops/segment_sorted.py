"""Sorted segment sum: kernel K2 and its plain version.

out[s] = sum of data[t] for t in [starts[s], starts[s + 1]), over rows
already grouped by ascending segment id; rows at or past starts[N] are
trailing padding and belong to no segment. The result is f32 [N, W] for
f32, bf16 or f16 rows. This is what `madrigal_tpu/ops/segment_pallas.py`
computes (the Pallas kernel `_kernel`, entered through
`sorted_segment_sum_mxu`). In the port it carries every sum the encoders
make: the segment sums and softmax denominators of `ops/segment.py`
(forward, through `sorted_sum`) and the transposes of the row gathers of
`ops/gather.py` (backward).

`sorted_segment_sum` launches the hand-written CUDA kernel
(`csrc/segment_sum.cu`, one warp per segment, f32 sums in ascending row
order, no atomics) for CUDA tensors and runs `sorted_segment_sum_plain`
for CPU tensors; there is no fallback between the two. The kernel is
built at first use by `ops/_build.py`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build


def segment_starts_np(sorted_ids: np.ndarray, num_segments: int,
                      total_rows: int | None = None) -> np.ndarray:
    """[num_segments + 1] boundary table for rows sorted by segment id:
    starts[s] = first row of segment s; starts[num_segments] = number of
    real rows, clipped to `total_rows` (rows at or beyond it are ignored,
    so padding rows can carry any trailing sentinel id)."""
    sorted_ids = np.asarray(sorted_ids)
    starts = np.searchsorted(sorted_ids, np.arange(num_segments + 1),
                             side="left").astype(np.int32)
    if total_rows is not None:
        starts[num_segments] = min(int(starts[num_segments]), total_rows)
    return starts


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def supports_sorted_segment_sum(dtype: torch.dtype, width: int) -> bool:
    """Whether the kernel takes [E, width] rows of `dtype`: f32, bf16 or
    f16 (each widens to f32 exactly), at any width. The JAX package's
    `supports_mxu_segment_sum` also asks for a width that is a multiple of
    128, which is the TPU's lane width; the CUDA kernel has a scalar path
    for any width."""
    return dtype in _DTYPE_CODE and width > 0


def row_segments(starts: torch.Tensor, num_rows: int) -> torch.Tensor:
    """[num_rows] int64: the segment s of each row t under `starts`
    (starts[s] <= t < starts[s + 1]); N (= len(starts) - 1) for rows
    before starts[0] or at or past starts[N], which belong to none."""
    n = starts.shape[0] - 1
    if starts.device.type == "cpu":  # a third of searchsorted's time
        s = starts.long().clamp(0, num_rows)
        lo, hi = int(s[0]), int(s[-1])
        seg = torch.full((num_rows,), n, dtype=torch.long)
        seg[lo:hi] = torch.repeat_interleave(
            torch.arange(n), s[1:] - s[:-1], output_size=hi - lo)
        return seg
    # on the card, with no wait for the device
    rows = torch.arange(num_rows, device=starts.device)
    seg = torch.searchsorted(starts.long(), rows, right=True) - 1
    return torch.where((seg >= 0) & (rows < starts[-1].long()), seg,
                       torch.full_like(seg, n))


def sorted_segment_sum_plain(data: torch.Tensor, starts: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """The same sums with `index_add_` over the segment ids of
    `row_segments`, in f32 (in f64 for f64 rows, which only the CPU
    takes)."""
    seg = row_segments(starts, data.shape[0])
    acc = torch.float64 if data.dtype == torch.float64 else torch.float32
    out = data.new_zeros((num_segments + 1, data.shape[1]), dtype=acc)
    out.index_add_(0, seg, data.to(acc))
    return out[:num_segments]


def _library():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("segment_sum", "madrigal_sorted_segment_sum",
                       [vp, vp, vp, ctypes.c_int64, ci, ci, ci, vp])


def sorted_segment_sum(data: torch.Tensor, starts: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """[num_segments, W] f32 segment sums of `data` [E, W] (f32, bf16 or
    f16, rows grouped by segment) under the boundary table `starts`
    [num_segments + 1] int32.

    CPU tensors run `sorted_segment_sum_plain`. CUDA tensors launch the
    kernel on the current stream; anything it does not take raises.
    `sorted_segment_sum.launches` counts kernel launches."""
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, starts, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dim() != 2:
        raise ValueError(f"data must be [E, W], got {tuple(data.shape)}")
    E, W = data.shape
    if not supports_sorted_segment_sum(data.dtype, W):
        raise ValueError(f"data must be float32, bfloat16 or float16 rows "
                         f"of a positive width, got {data.dtype}, {W}")
    if starts.dtype != torch.int32:
        raise ValueError(f"starts must be int32, got {starts.dtype}")
    dev = data.device
    _build.check_operand("data", data, (E, W), dev,
                         align=data.element_size())
    _build.check_operand("starts", starts, (num_segments + 1,), dev, align=4)
    out = torch.empty((num_segments, W), dtype=torch.float32, device=dev)
    if num_segments == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().madrigal_sorted_segment_sum(
        data.data_ptr(), starts.data_ptr(), out.data_ptr(), E, num_segments,
        W, _DTYPE_CODE[data.dtype], stream)
    if err != 0:
        raise RuntimeError(f"segment-sum kernel launch failed: CUDA error {err}")
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0


class SortedSum(torch.autograd.Function):
    """sorted_segment_sum made differentiable, over rows in any order.

    data [E, ...]; starts [N + 1] int32, the boundary table over the rows
    in the order `order` [E] int32 (a permutation of the row axis), or in
    their own order when `order` is None. Forward: K2 (on the CPU its plain
    version) on the grouped rows, f32 out (f64 for f64 rows). Backward:
    each row's cotangent is the cotangent row of its segment, a gather
    (rows in no segment get zeros), so no sum runs and no `index_add_`."""

    @staticmethod
    def forward(ctx, data, starts, order):
        num_segments = starts.shape[0] - 1
        rows = data.reshape(data.shape[0], -1)
        if order is not None:
            rows = rows.index_select(0, order)
        out = sorted_segment_sum(rows.contiguous(), starts, num_segments)
        ctx.save_for_backward(starts, order)
        ctx.data_shape, ctx.data_dtype = data.shape, data.dtype
        return out.reshape((num_segments,) + tuple(data.shape[1:]))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cot):
        starts, order = ctx.saved_tensors
        seg = row_segments(starts, ctx.data_shape[0])
        if order is not None:  # row order[t] sits at position t
            seg = torch.empty_like(seg).index_put_((order.long(),), seg)
        cot = torch.cat([cot, cot.new_zeros((1,) + tuple(cot.shape[1:]))])
        return cot[seg].to(ctx.data_dtype), None, None


def sorted_sum(data: torch.Tensor, starts: torch.Tensor,
               order: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable segment sums of `data` [E, ...] under the layout
    (`starts`, `order`) of SortedSum: [len(starts) - 1, ...], f32 (f64
    for f64 rows)."""
    return SortedSum.apply(data, starts, order)
