"""Pair x outcome bilinear scores: kernel K1 and its plain version.

out[l, i, j] = round_c(z_head[i] . W_l) . z_tail[j] over a symmetrized
W [L, D, D]; the first product accumulates in f32 and is rounded to
`compute_dtype`, the second accumulates in f32 and is written as
`out_dtype`. This is what `madrigal_tpu/ops/bilinear_pallas.py` computes
(the Pallas kernel `_make_kernel._kernel`, and `bilinear_scores_xla` as
its plain form).

`bilinear_scores` launches the hand-written CUDA kernel
(`csrc/bilinear.cu`) for CUDA tensors and runs `bilinear_scores_plain`
for CPU tensors; there is no fallback between the two. The kernel is
built at first use by `ops/_build.py` (nvcc for sm_90a into
`build/kernels/`, loaded with ctypes).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

D = 128


def bilinear_scores_plain(z_head: torch.Tensor, z_tail: torch.Tensor,
                          w_sym: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16,
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """The two matmuls of `bilinear_scores_xla`, with its rounding points.

    Inputs are rounded to `compute_dtype` and multiplied in f32 (a product
    of two bf16 values is exact in f32), so both sums accumulate in f32 as
    with `preferred_element_type=float32`."""
    zh = z_head.to(compute_dtype).float()
    zt = z_tail.to(compute_dtype).float()
    w = w_sym.to(compute_dtype).float()
    zw = torch.matmul(zh, w).to(compute_dtype).float()  # [L, M, D]
    return torch.matmul(zw, zt.T).to(out_dtype)


def _library():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("bilinear", "madrigal_bilinear_scores",
                       [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp])


def bilinear_scores(z_head: torch.Tensor, z_tail: torch.Tensor,
                    w_sym: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """[L, M, N] scores of z_head [M, 128], z_tail [N, 128] and the
    symmetrized w_sym [L, 128, 128].

    CPU tensors run `bilinear_scores_plain`. CUDA tensors launch the
    kernel on the current stream (inputs are first cast to
    `compute_dtype`); anything the kernel does not take raises.
    `bilinear_scores.launches` counts kernel launches."""
    if z_head.device.type == "cpu":
        return bilinear_scores_plain(z_head, z_tail, w_sym, out_dtype,
                                     compute_dtype)
    if z_head.device.type != "cuda":
        raise ValueError(f"unsupported device {z_head.device}")
    for dt, what in ((compute_dtype, "compute_dtype"), (out_dtype, "out_dtype")):
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{what} must be float32 or bfloat16, got {dt}")
    if z_head.dim() != 2 or z_tail.dim() != 2 or w_sym.dim() != 3:
        raise ValueError("expected z_head [M, D], z_tail [N, D], w [L, D, D]")
    M, N, L = z_head.shape[0], z_tail.shape[0], w_sym.shape[0]
    dev = z_head.device
    zh = z_head.to(compute_dtype)
    zt = z_tail.to(compute_dtype)
    w = w_sym.to(compute_dtype)
    _build.check_operand("z_head", zh, (M, D), dev)
    _build.check_operand("z_tail", zt, (N, D), dev)
    _build.check_operand("w_sym", w, (L, D, D), dev)
    out = torch.empty((L, M, N), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    # enough blocks to fill the card: split each block's z_tail sweep
    # when the (row tile, outcome) grid alone is small
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = -(-M // 64) * L
    splits = max(1, -(-2 * sms // blocks))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().madrigal_bilinear_scores(
        zh.data_ptr(), zt.data_ptr(), w.data_ptr(), out.data_ptr(),
        L, M, N, int(compute_dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), splits, stream)
    if err != 0:
        raise RuntimeError(f"bilinear kernel launch failed: CUDA error {err}")
    bilinear_scores.launches += 1
    return out


bilinear_scores.launches = 0
