"""Host -> device moves (the part of the port's `data/pipeline.py` that
the stage-2 trainer's serial step uses)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch



def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], obj):
    """`obj` with `fn` applied to each tensor leaf (numpy arrays become
    tensors first)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, np.ndarray):
        return fn(torch.from_numpy(np.ascontiguousarray(obj)))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


def to_device(obj, device: torch.device):
    """A host batch on `device`, copied synchronously (the serial loop)."""
    return map_tensors(lambda t: t.to(device), obj)
