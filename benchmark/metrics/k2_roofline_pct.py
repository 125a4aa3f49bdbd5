"""Kernel K2's share of its roofline: over the traced window's K2 calls
(each in its span), the least time their work needs (counting.k2_bound
of each call's real rows, segments, width and type) over the device time
of K2's kernels launched in those spans."""
import re

from counting import k2_bound

# every __global__ function of csrc/segment_sum.cu: the first launch
# (segment_sum_kernel at 32 lanes a row, segment_groups_kernel below) and
# the second, which adds the long segments' pieces (segment_combine_kernel,
# segment_combine_groups_kernel)
KERNELS = re.compile(r"(^|::)segment_(sum|groups|combine|combine_groups)"
                     r"_kernel(<|$)")


def read(ctx):
    bound_s = device_us = 0.0
    for span, shape in (ctx.k2_calls or {}).items():
        us = sum(dur for name, _, dur, _ in ctx.k2_ops.get(span, ())
                 if KERNELS.search(name))
        if us > 0:
            bound_s += k2_bound(*shape)[0]
            device_us += us
    if device_us <= 0:
        return None
    return 100.0 * bound_s / (device_us / 1e6)
