"""Device milliseconds an outcome of the rank export spends outside K1:
the lower triangle's gather, the sort, the scatters and the
symmetrization."""
import re

K1 = re.compile(r"(^|::)(gemm_f32|bilinear_kernel)(<|$)")


def read(ctx):
    if ctx.kind != "ranks" or not ctx.units:
        return None
    us = sum(dur for name, _, dur, _ in ctx.ops
             if not K1.search(name))
    return us / 1e3 / ctx.units
