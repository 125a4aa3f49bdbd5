"""Device milliseconds a training step spends in the port's span
`madrigal.draw`: the host's draw of the step's masks (and, in stage 2,
its drugs) and their copy to the card. The span launches little, so its
time between markers is mostly the card waiting for the host."""
from spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "madrigal.draw")
