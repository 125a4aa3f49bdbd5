"""The benchmark's plain reference.

A copy of the port's model, data and trainer code cut to what the
benchmark's cells run (GIN, HGT, the cv MLP, chemCPA, the transformer
fusion, the decoder's triples, AdamW with its schedules, the collator's
full batch, the maskers and losses), with its two kernels replaced by
plain PyTorch: every segment sum and every gather transpose accumulates
in float64 and is rounded once (`ops/segment.py`), so it is the exact
sum rounded, in any order of the device's adds; the rank cell's scores
are two `torch.matmul`s (`ranks.py`). No sorted layout is built. A
choice that no configuration makes raises. `device.resolve_device`
leaves the float32 matmul precision as the caller set it.

It imports nothing of the port or of the JAX package, and takes nothing
the port made: it collates and masks its own inputs from the raw
dataset the benchmark generates (`data/synthetic.py`, the generator
both sides read).
"""
