"""Device milliseconds a training step spends in cuBLAS's matrix products
(kernels named like gemm, gemv or splitKreduce; not K1's)."""
import re

PATTERNS = ("gemm", "gemv", "splitkreduce")
K1 = re.compile(r"(^|::)(gemm_f32|bilinear_kernel)(<|$)")


def read(ctx):
    if ctx.kind != "train" or not ctx.units:
        return None
    us = sum(dur for name, _, dur, _ in ctx.ops
             if any(p in name.lower() for p in PATTERNS)
             and not K1.search(name))
    return us / 1e3 / ctx.units
