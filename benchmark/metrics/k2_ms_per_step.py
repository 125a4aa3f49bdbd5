"""Device milliseconds a training step spends in the port's spans
`madrigal.k2` (`ops/segment_sorted.sorted_segment_sum` on CUDA), summed
over every K2 call of the step: the forward's sums and the backward's
gather transposes, which run on autograd's thread inside the step's
`madrigal.backward`."""
from spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "madrigal.k2")
