"""Checkpoints with embedded configs: save and load (port of the save /
load half of `madrigal_tpu/train/checkpoint.py`).

Format: `torch.save({"state_dict", "cfg": config.to_dict(cfg),
"cfg_type"})`; the model is rebuilt from the embedded config alone, as
the reference does (predict.py:20-23). The JAX package's orbax
checkpoints cannot be read without JAX; carry JAX weights across with
`interop/from_flax.py` instead.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch
from torch import nn

from .. import config as config_lib


def save_checkpoint(path: str, model: nn.Module, cfg: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "state_dict": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
        "cfg": config_lib.to_dict(cfg),
        "cfg_type": type(cfg).__name__,
    }, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(state_dict on the CPU, config rebuilt with config.from_dict)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    cls = getattr(config_lib, blob["cfg_type"])
    return blob["state_dict"], config_lib.from_dict(cls, blob["cfg"])
