"""The card's live memory at the end of a forward, in GB (1e9 bytes):
the largest `torch.cuda.memory_allocated` at the exit of the port's
spans `madrigal.forward` in the traced window, which holds the
activations the backward will read."""
from spans import named


def read(ctx):
    found = named(ctx, "train", "madrigal.forward")
    if found is None or any(r.live_bytes is None for r in found):
        return None
    return max(r.live_bytes for r in found) / 1e9
