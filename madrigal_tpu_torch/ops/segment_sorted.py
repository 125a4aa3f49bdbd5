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
(`csrc/segment_sum.cu`: f32 sums in a fixed order, long segments split
into pieces of `split_rows()` rows that run on lanes of their own, rows
narrower than a warp's span summed by groups of lanes, `lane_group`; no
atomics) for CUDA tensors and runs `sorted_segment_sum_plain` for CPU
tensors; there is no fallback between the two. The kernel is built at
first use by `ops/_build.py`. `sorted_segment_sum_ordered` takes the
kernel's order of the sums in plain PyTorch, so that the kernel can be
held to it bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from ..utils.profiling import span


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


def row_alignment(address: int) -> int:
    """The largest power of two, up to 32, that divides `address` (the
    rows' first byte): what the kernel reads of the rows' alignment."""
    align = 1
    while align < 32 and address % (2 * align) == 0:
        align *= 2
    return align


def lane_group(width: int, dtype: torch.dtype, align: int) -> tuple:
    """(VEC, G) of the kernel's first launch on [E, width] rows of `dtype`
    whose address is a multiple of `align` bytes, as `mapping` in
    `csrc/segment_sum.cu` picks them: VEC, the values a lane loads of a
    row, is 8 where the width is a multiple of 256, 4 where it is a
    multiple of 4, each only where the rows are aligned for that load,
    else 1; G, the lanes a row takes, is ceil(width / VEC) rounded up to
    a power of two, at most 32. A warp sums 32 / G pieces at once, one a
    group of G lanes."""
    elem = torch.finfo(dtype).bits // 8
    align = row_alignment(align)
    if width % 256 == 0 and align % (8 * elem) == 0:
        vec = 8
    elif width % 4 == 0 and align % (4 * elem) == 0:
        vec = 4
    else:
        vec = 1
    group = 1
    while group < -(-width // vec) and group < 32:
        group *= 2
    return vec, group


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


def sorted_segment_sum_ordered(data: torch.Tensor, starts: torch.Tensor,
                               num_segments: int,
                               split_rows: int) -> torch.Tensor:
    """The sums of `sorted_segment_sum_plain`, taken in the kernel's
    order, so that the kernel equals it bit for bit: a segment of
    L <= split_rows (P) rows is summed in f32 (f64 for f64 rows) from 0,
    one row after another in ascending order; a longer one is cut into
    pieces of P rows from its first row, each summed so into a partial
    p_k, and out = (..((p_0 + p_1) + p_2) ..), in ascending k. A loop over
    the row offset within a piece, over every piece at once, then a loop
    over the pieces. For tests and the card's checks only."""
    P = split_rows
    n, (E, W) = num_segments, data.shape
    dev = data.device
    acc = torch.float64 if data.dtype == torch.float64 else torch.float32
    out = torch.zeros((n, W), dtype=acc, device=dev)
    # each segment's span [b, e), clipped to the real rows [0,
    # min(starts[N], E)) as the kernel clips it
    st = starts.long()
    b = st[:n].clamp(min=0)
    e = torch.maximum(torch.minimum(st[1:], st[n].clamp(max=E)), b)
    pieces = (e - b + P - 1) // P  # 0 for an empty segment
    total = int(pieces.sum())
    if total == 0:
        return out
    seg = torch.repeat_interleave(torch.arange(n, device=dev), pieces,
                                  output_size=total)
    first = torch.cumsum(pieces, 0) - pieces  # piece 0 of each segment
    index = torch.arange(total, device=dev) - first[seg]  # k, per piece
    p_start = b[seg] + index * P
    p_len = torch.minimum(e[seg] - p_start, torch.full_like(p_start, P))
    # the pieces longest first, so the pieces still summing at offset j
    # are a prefix
    by_len = torch.argsort(p_len, descending=True, stable=True)
    p_start, lens = p_start[by_len], p_len[by_len].cpu()
    live = torch.searchsorted(-lens, -torch.arange(int(lens[0]))).tolist()
    rows = data.to(acc)
    part = torch.zeros((total, W), dtype=acc, device=dev)
    for j, m in enumerate(live):
        part[:m] += rows[p_start[:m] + j]
    partial = torch.empty_like(part)
    partial[by_len] = part
    # the partials in ascending k, the segments with the most pieces first
    # (those with more than k pieces are a prefix)
    by_count = torch.argsort(pieces, descending=True, stable=True)
    counts, first = pieces[by_count].cpu(), first[by_count]
    live = torch.searchsorted(-counts, -torch.arange(int(counts[0]))).tolist()
    sums = torch.zeros((n, W), dtype=acc, device=dev)
    sums[:live[0]] = partial[first[:live[0]]]
    for k, m in enumerate(live[1:], 1):
        sums[:m] += partial[first[:m] + k]
    out[by_count] = sums
    return out


@functools.lru_cache(maxsize=None)
def _kernel() -> tuple:
    """(the kernel's C entry, P, its library), from the library built at
    first use."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = _build.load("segment_sum", "madrigal_sorted_segment_sum",
                      [vp, vp, vp, vp, ctypes.c_int64, ci, ci, ci, vp])
    lib.madrigal_segment_split_rows.argtypes = []
    lib.madrigal_segment_split_rows.restype = ci
    for entry in (lib.madrigal_segment_lane_group,
                  lib.madrigal_segment_vector):
        entry.argtypes, entry.restype = [ci, ci, ci], ci
    return (lib.madrigal_sorted_segment_sum,
            lib.madrigal_segment_split_rows(), lib)


def split_rows() -> int:
    """P, the rows of a piece, from the built kernel (needs nvcc)."""
    return _kernel()[1]


def kernel_lane_group(width: int, dtype: torch.dtype, align: int) -> tuple:
    """(VEC, G) as the built kernel picks them (needs nvcc): what
    `lane_group` mirrors."""
    lib, code = _kernel()[2], _DTYPE_CODE[dtype]
    return (lib.madrigal_segment_vector(width, code, align),
            lib.madrigal_segment_lane_group(width, code, align))


# the current stream's raw handle, without making the Stream object of
# torch.cuda.current_stream (some 7 us of host time a call on an H100's
# host): torch's private getter, where this build has it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)

# One scratch buffer of _SCRATCH_KEPT floats is kept for each (device,
# stream) whose launches (which run in order on it) need no more, so that
# the calls of tens of us, whose time the host's allocation would add to,
# allocate nothing. A larger need (rows by the million at 128 wide, calls
# of 0.1 ms and more) gets a buffer of its own, freed when the call
# returns, and so does a call while a CUDA graph is captured.
_SCRATCH_KEPT = 1 << 16
_scratch: dict = {}


def _scratch_for(dev, stream: int, numel: int) -> torch.Tensor:
    """At least `numel` f32 of scratch for a launch on `stream`."""
    if numel > _SCRATCH_KEPT or torch.cuda.is_current_stream_capturing():
        return torch.empty(numel, dtype=torch.float32, device=dev)
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.empty(_SCRATCH_KEPT, dtype=torch.float32,
                                          device=dev)
    return buf


def sorted_segment_sum(data: torch.Tensor, starts: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """[num_segments, W] f32 segment sums of `data` [E, W] (f32, bf16 or
    f16, rows grouped by segment) under the boundary table `starts`
    [num_segments + 1] int32.

    CPU tensors run `sorted_segment_sum_plain`. CUDA tensors launch the
    kernel on the current stream, in the order of
    `sorted_segment_sum_ordered`; anything it does not take raises.
    `sorted_segment_sum.launches` counts calls that launched the kernel
    (its two CUDA kernels count as one)."""
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, starts, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dim() != 2:
        raise ValueError(f"data must be [E, W], got {tuple(data.shape)}")
    with span("madrigal.k2") as record:
        if record is not None:  # a profiler records: the call's shape
            record.attrs = {"rows": data.shape[0], "segments": num_segments,
                            "width": data.shape[1], "dtype": data.dtype}
        return _cuda_sums(data, starts, num_segments)


def _cuda_sums(data, starts, num_segments):
    """sorted_segment_sum on CUDA tensors: the checks, the output and the
    launch."""
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
    kernel, P, _ = _kernel()
    stream = (_raw_stream(dev.index) if _raw_stream is not None
              else torch.cuda.current_stream(dev).cuda_stream)
    # the pieces' partials; no segment is longer than P unless E is
    scratch = _scratch_for(dev, stream, -(-E // P) * W) if E > P else None
    err = kernel(data.data_ptr(), starts.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), E,
                 num_segments, W, _DTYPE_CODE[data.dtype], stream)
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
