"""Device milliseconds a training step spends in the port's spans
`madrigal.forward`: every forward of the step (stage 3: the KG table,
then each forward of the mode's plan; stage 2: the two-view model call),
the KG pass inside them included."""
from spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "madrigal.forward")
