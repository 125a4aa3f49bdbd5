"""Kernel K1's share of its roofline: the least time its calls' work
needs (counting.k1_bound: the inputs read once, the scores written once,
the operations at the compute type's peak) over the device time of K1's
kernels in the traced window."""
import re

from counting import k1_bound

# K1's kernels (csrc/bilinear.cu): f32::gemm_f32<...> and
# bilinear_kernel<...>; cuBLAS's sm90_xmma_gemm_f32f32_... are not
KERNELS = re.compile(r"(^|::)(gemm_f32|bilinear_kernel)(<|$)")


def read(ctx):
    device_us = sum(dur for name, _, dur, _ in ctx.ops
                    if KERNELS.search(name))
    if not ctx.k1_calls or device_us <= 0:
        return None
    bound_s = sum(k1_bound(*call)[0] for call in ctx.k1_calls)
    return 100.0 * bound_s / (device_us / 1e6)
