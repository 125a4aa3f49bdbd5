"""The training step's share of the card's float32 peak: the model
operations a step needs (every matrix product of its forward, counted on
the reference, times 3) over the seconds a step took in the run's
untraced window of as many steps as it traces, against 67 TF/s (float32
without TF32, the configurations' compute type)."""
import torch

from counting import PEAK_OPS_PER_S


def read(ctx):
    if (ctx.kind != "train" or not ctx.model_ops_per_unit or not ctx.units
            or not ctx.untraced_s):
        return None
    rate = ctx.model_ops_per_unit * ctx.units / ctx.untraced_s
    return 100.0 * rate / PEAK_OPS_PER_S[torch.float32]
