"""Device milliseconds an outcome of the rank export spends in the
port's span `madrigal.k1` (`ops/bilinear.bilinear_scores` on CUDA): the
casts, the allocation of the scores and scratch, and K1's launches."""
from spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "ranks", "madrigal.k1")
