"""The rank export's share of the card's float32 peak: the bilinear
scores' operations an outcome needs (z @ W_l, then times z^T) over the
seconds an outcome took in the same run's untraced window of the traced
window's calls, against 67 TF/s."""
import torch

from counting import PEAK_OPS_PER_S


def read(ctx):
    if (ctx.kind != "ranks" or not ctx.model_ops_per_unit or not ctx.units
            or not ctx.untraced_s):
        return None
    rate = ctx.model_ops_per_unit * ctx.units / ctx.untraced_s
    return 100.0 * rate / PEAK_OPS_PER_S[torch.float32]
