"""Checkpoints with embedded configs (port of `madrigal_tpu/train/
checkpoint.py`): save, load, resume, the stage-2 -> stage-3 warm start,
early stopping and the finite-loss check.

Format: `torch.save({"state_dict", "cfg": config.to_dict(cfg), "cfg_type",
"epoch", "opt_state", "extra"})`; the model is rebuilt from the embedded
config alone, as the reference does (predict.py:20-23), and a training
run resumes from `epoch` and `opt_state` (the optimizer's and the
schedule's state dicts). A stage-2 checkpoint (`cli/pretrain.py`:
`cl_checkpoint_{k}`, `cl_last`) is a `SimCLRModel` state_dict under a
`PretrainConfig`, its `epoch` the checkpoint boundary and
`extra["steps"]` the steps taken. The JAX package's orbax checkpoints
cannot be read without JAX; carry JAX weights across with
`interop/from_flax.py` instead (`stage2_checkpoint_from_flax` for a
stage-2 run).

The warm start (reference utils.py:246-307; the JAX CLI's `--checkpoint`,
cli/train_ddi.py:250-265) overlays a stage-2 checkpoint's encoder
*parameters* onto a freshly initialized model: the fusion modules are
dropped so that stage 3 re-initializes them, and the BatchNorm running
statistics stay the fresh model's, as the JAX package overlays `params`
and keeps its fresh `batch_stats`.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from .. import config as config_lib


def save_checkpoint(path: str,
                    model: Union[nn.Module, Mapping[str, torch.Tensor]],
                    cfg: Any, epoch: Optional[int] = None,
                    opt_state: Optional[dict] = None,
                    extra: Optional[dict] = None) -> None:
    """Save `model` (a module or a state_dict) with its config."""
    sd = model if isinstance(model, Mapping) else model.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "state_dict": {k: v.detach().cpu() for k, v in sd.items()},
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


# --------------------------------------------------------------------------
# CL -> finetune transfer (utils.py:246-307)
# --------------------------------------------------------------------------

CL_TRANSFER_DROP_TOP = ("transformer", "pos_encoder", "cls",
                        "tx_bottleneck_tokens")


def checkpoint_encoder(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A stage-2 checkpoint's encoder entries, their `base_encoder.`
    prefix removed, else those under `encoder.` (the JAX CLI's
    `params.get("base_encoder", params.get("encoder"))`)."""
    for prefix in ("base_encoder.", "encoder."):
        enc = {k[len(prefix):]: v for k, v in state_dict.items()
               if k.startswith(prefix)}
        if enc:
            return enc
    raise KeyError("the checkpoint holds no base_encoder.* or encoder.* "
                   "entries")


def filter_cl_params_for_finetune(encoder_params: Mapping[str, Any],
                                  use_pretrained_adaptor: bool = False
                                  ) -> Dict[str, Any]:
    """Keep the modality-encoder weights; drop the fusion modules (the
    transformer, positional encoding, CLS and bottleneck tokens) and,
    unless use_pretrained_adaptor, the uni projector, so that the
    finetune stage re-initializes them (reference utils.py:281-296).
    Keys are encoder state_dict names."""
    out = {}
    for k, v in encoder_params.items():
        top = k.split(".")[0]
        if top in CL_TRANSFER_DROP_TOP:
            continue
        if top == "uni_projector" and not use_pretrained_adaptor:
            continue
        out[k] = v
    return out


def merge_params(init_params: Mapping[str, torch.Tensor],
                 loaded: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """`init_params` with each `loaded` entry put in its place; entries
    not loaded keep their fresh values. A shape mismatch raises
    ValueError, and a loaded name the model lacks raises KeyError (a
    torch module has no slot for it)."""
    out = dict(init_params)
    for k, v in loaded.items():
        if k not in out:
            raise KeyError(f"the model has no parameter {k!r}")
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: "
                             f"{tuple(out[k].shape)} vs {tuple(v.shape)}")
        out[k] = v
    return out


@torch.no_grad()
def warm_start_encoder(model: nn.Module, state_dict: Mapping[str, Any],
                       use_pretrained_adaptor: bool = False) -> list:
    """Overlay a stage-2 checkpoint's encoder parameters onto `model`
    (a MadrigalMultilabel) in place, through
    filter_cl_params_for_finetune and merge_params. Only parameters are
    merged: the checkpoint's BatchNorm statistics are left out and the
    model's stay as they are. Returns the encoder parameter names taken
    from the checkpoint."""
    enc = model.encoder
    buffers = {k for k, _ in enc.named_buffers()}
    loaded = {k: v for k, v in checkpoint_encoder(state_dict).items()
              if k not in buffers}
    kept = filter_cl_params_for_finetune(loaded, use_pretrained_adaptor)
    params = dict(enc.named_parameters())
    merged = merge_params({k: p.detach() for k, p in params.items()}, kept)
    for k in kept:
        params[k].copy_(merged[k])
    return sorted(kept)


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
