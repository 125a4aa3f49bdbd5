"""Device milliseconds an outcome of the rank export spends in the
port's span `madrigal.rank_sort` (`eval/ranks.
normalized_ranks_for_outcomes` after K1): the lower triangle's order,
then each outcome's gather, sort, scatters and symmetrization."""
from spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "ranks", "madrigal.rank_sort")
