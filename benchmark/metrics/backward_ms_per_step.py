"""Device milliseconds a training step spends in the port's spans
`madrigal.backward`: every `loss.backward()` of the step and stage 3's
backward of the KG table, K2's gather transposes and the HGT's
recomputed forwards included."""
from spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "madrigal.backward")
