"""Sorted segment sum: kernel K2 and its plain version.

out[s] = sum of data[t] for t in [starts[s], starts[s + 1]), over rows
already grouped by ascending segment id; rows at or past starts[N] are
trailing padding and belong to no segment. The result is f32 [N, W] for
f32, bf16 or f16 rows. This is what `madrigal_tpu/ops/segment_pallas.py`
computes (the Pallas kernel `_kernel`, entered through
`sorted_segment_sum_mxu`); it is the backward of the HGT's source gather
(`ops/gather.py`).

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


def sorted_segment_sum_plain(data: torch.Tensor, starts: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """The same sums with `index_add_` over segment ids made from `starts`,
    in f32: row t belongs to the segment s with starts[s] <= t <
    starts[s + 1], and rows before starts[0] or at or past starts[N] to
    none."""
    rows = torch.arange(data.shape[0], device=data.device)
    seg = torch.searchsorted(starts.long(), rows, right=True) - 1
    seg = torch.where((seg >= 0) & (rows < starts[-1].long()), seg,
                      torch.full_like(seg, num_segments))
    out = data.new_zeros((num_segments + 1, data.shape[1]),
                         dtype=torch.float32)
    out.index_add_(0, seg, data.float())
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
