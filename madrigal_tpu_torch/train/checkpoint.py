"""Checkpoints with embedded configs (port of `madrigal_tpu/train/
checkpoint.py`): save, load, resume, early stopping and the finite-loss
check.

Format: `torch.save({"state_dict", "cfg": config.to_dict(cfg), "cfg_type",
"epoch", "opt_state", "extra"})`; the model is rebuilt from the embedded
config alone, as the reference does (predict.py:20-23), and a training
run resumes from `epoch` and `opt_state` (the optimizer's and the
schedule's state dicts). The JAX package's orbax checkpoints cannot be
read without JAX; carry JAX weights across with `interop/from_flax.py`
instead.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .. import config as config_lib


def save_checkpoint(path: str, model: nn.Module, cfg: Any,
                    epoch: Optional[int] = None,
                    opt_state: Optional[dict] = None,
                    extra: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "state_dict": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
        "cfg": config_lib.to_dict(cfg),
        "cfg_type": type(cfg).__name__,
        "epoch": epoch,
        "opt_state": opt_state,
        "extra": extra or {},
    }, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(state_dict on the CPU, config rebuilt with config.from_dict)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    cls = getattr(config_lib, blob["cfg_type"])
    return blob["state_dict"], config_lib.from_dict(cls, blob["cfg"])


def load_train_state(path: str) -> Tuple[Optional[int], Optional[dict], dict]:
    """(epoch, opt_state, extra) of a checkpoint, for a resume."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob.get("epoch"), blob.get("opt_state"), blob.get("extra") or {}


class EarlyStopping:
    """Patience-based early stopping on a maximized score
    (reference: chemCPA/model.py:714-727)."""

    def __init__(self, patience: int = 5):
        self.patience = patience
        self.best_score = -1e3
        self.trials = 0

    def __call__(self, score: Optional[float]) -> bool:
        if score is None:
            return False
        if score > self.best_score:
            self.best_score = score
            self.trials = 0
        else:
            self.trials += 1
        return self.trials > self.patience


def check_finite_loss(losses, context: str = "train"):
    """Raise FloatingPointError, naming the offending keys, when a loss is
    not finite (the reference aborts chemCPA training on a NaN loss --
    experiments_run.py:336-343); otherwise return the losses."""
    if isinstance(losses, dict):
        bad = [k for k, v in losses.items() if not math.isfinite(float(v))]
        if bad:
            raise FloatingPointError(
                f"non-finite {context} loss in {bad}: "
                f"{ {k: float(losses[k]) for k in bad} }")
    elif not math.isfinite(float(losses)):
        raise FloatingPointError(f"non-finite {context} loss: {losses}")
    return losses
