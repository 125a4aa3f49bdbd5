"""Device milliseconds a training step spends in the port's span
`madrigal.kg_pass` (`MadrigalEncoder.kg_drug_table`): the HGT's forward
over the whole KG, its sums on K2. A part of `forward_ms_per_step`."""
from spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "madrigal.kg_pass")
