"""What the readers of the port's own spans share: the spans that
`madrigal_tpu_torch.utils.profiling.span` recorded in the newest profiler
session, the traced window's, read through `profiling.recorded()`. Each
record carries its name, its parent span, its device milliseconds (the
card's time between its two markers) and the live bytes at its exit. A
port without that recorder gives no records, so its readers find
nothing."""
from __future__ import annotations


def records() -> list:
    """The port's span records of the newest profiler session; [] where
    the port keeps none."""
    try:
        from madrigal_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "recorded", None)
    return [] if read is None else read()


def named(ctx, kind: str, name: str):
    """The records of span `name`, each with its device time; None where
    the cell is not of `kind`, the window completed no unit, no such
    record exists or one has no device time (a CPU run)."""
    if ctx.kind != kind or not ctx.units:
        return None
    found = [r for r in records() if r.name == name]
    if not found or any(r.device_ms is None for r in found):
        return None
    return found


def ms_per_unit(ctx, kind: str, name: str):
    """The device milliseconds of every span `name` of the window, over
    the units (steps or outcomes) it completed; None as `named`."""
    found = named(ctx, kind, name)
    if found is None:
        return None
    return sum(r.device_ms for r in found) / ctx.units
