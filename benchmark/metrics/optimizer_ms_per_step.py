"""Device milliseconds a training step spends in the port's span
`madrigal.optimizer`: the zero gradients of the parameters the loss does
not reach, the gradients' reduction where sharded, AdamW's step and the
schedule's."""
from spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "madrigal.optimizer")
