"""The yardstick's arithmetic: the card's published peaks, the least time
each kernel's work needs, and a step's model operations.

A kernel's bound counts each input byte read once and each output byte
written once, against the operations at the compute type's peak; the
larger of the two times bounds it. A step's model operations are every
matrix product of its forward, counted on the plain reference, times 3
(forward and backward), with no recomputation and no elementwise work.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet (dense, no sparsity): HBM3 bandwidth, the
# bf16 tensor-core rate and the float32 rate outside the tensor cores
# (the configurations run float32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
D = 128  # K1's embedding width


def k1_bound(L: int, M: int, N: int, compute: torch.dtype,
             out: torch.dtype) -> tuple:
    """(least seconds, 'bytes' or 'operations') of one K1 call, z_head
    [M, D] and z_tail [N, D] against w_sym [L, D, D]: both products
    (z_head @ W_l, then times z_tail^T) and the [L, M, N] scores written
    once."""
    cs = torch.finfo(compute).bits // 8
    os_ = torch.finfo(out).bits // 8
    nbytes = (M * D + N * D + L * D * D) * cs + L * M * N * os_
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = k1_ops(L, M, N) / PEAK_OPS_PER_S[compute]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k1_ops(L: int, M: int, N: int) -> int:
    """Multiply-adds of one K1 call, counted as 2 operations each."""
    return 2 * L * M * D * D + 2 * L * M * N * D


def k2_bound(rows: int, n: int, w: int, dtype: torch.dtype) -> tuple:
    """(least seconds, 'bytes' or 'operations') of one K2 call: `rows`
    real rows of width `w` read once, the [n, w] float32 sums and the
    [n + 1] int32 boundary table written or read once, one float32 add
    per input value."""
    nbytes = rows * w * (torch.finfo(dtype).bits // 8) + n * w * 4 + (
        n + 1) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = rows * w / PEAK_OPS_PER_S[torch.float32]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def forward_matmul_ops(fn) -> int:
    """Operations of every matrix product (mm, addmm, bmm, baddbmm,
    convolution, attention) that `fn()` runs without gradients, each
    multiply-add counted as 2, by torch's registry of operation counts
    (the one FlopCounterMode reads)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                Count.total += int(count(*args, **kwargs, out_val=out))
            return out

    with torch.no_grad(), Count():
        fn()
    return Count.total
