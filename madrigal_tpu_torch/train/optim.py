"""Optimizer and schedule of stage-3 training (port of
`madrigal_tpu/train/optim.py`; reference madrigal/utils.py:446-694).

Five learning rates (structure / kg / perturb / fusion / decoder), each
with a no-decay twin ('<group>_nd': biases, LayerNorm scales, the learned
tokens, GIN eps and learned positions), as AdamW parameter groups; the
chemCPA `drug_embeddings` table is 'frozen' and in no group. The labels
are the JAX package's, read off each parameter's flax path: a torch
parameter's path is its module path with the leaf renamed back (a Linear
weight is a flax `kernel`, an Embedding weight an `embedding`, a norm
weight a `scale`).

The schedule is linear warmup then cosine decay, per epoch, as a
LambdaLR: one optimizer step is one epoch, and update k uses the
schedule at k (the first update at 0), as optax counts.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from ..config import OptimizerConfig
from ..models.norm import MaskedBatchNorm

# parameters that never get weight decay (utils.py:446-498)
NO_DECAY_LEAF_NAMES = {"bias"}
NO_DECAY_PARAM_NAMES = {
    "cls", "tx_bottleneck_tokens", "x_attn_query", "eps", "pe",
}
LN_MODULE_HINTS = ("norm1", "norm2", "x_attn_kv_norm", "x_attn_query_norm")
GROUPS = ("str", "kg", "perturb", "fusion", "decoder")


def _group_of(parts: Tuple[str, ...]) -> str:
    """A parameter path's LR group (utils.py:473-479)."""
    if "str_encoder" in parts:
        return "str"
    if "kg_encoder" in parts:
        return "kg"
    if ("cv_encoder" in parts or "tx_encoder" in parts
            or any(p.startswith("tab_encoder_") for p in parts)):
        return "perturb"
    if parts[0] == "decoder":
        return "decoder"
    return "fusion"


def _is_no_decay(parts: Tuple[str, ...]) -> bool:
    leaf = parts[-1]
    if leaf in NO_DECAY_LEAF_NAMES or leaf in NO_DECAY_PARAM_NAMES:
        return True
    # LayerNorm scales; an MLPEncoder 'norm_{i}' is excluded whether it is
    # a LayerNorm or a BatchNorm, as in the JAX package
    return leaf == "scale" and any(
        h in p for p in parts for h in LN_MODULE_HINTS + ("norm_",))


def _flax_leaf(module: nn.Module, name: str) -> str:
    if name == "weight":
        if isinstance(module, nn.Linear):
            return "kernel"
        if isinstance(module, nn.Embedding):
            return "embedding"
        if isinstance(module, (nn.LayerNorm, MaskedBatchNorm)):
            return "scale"
    return name


def param_labels(model: nn.Module) -> Dict[str, str]:
    """{parameter name: '<group>', '<group>_nd' or 'frozen'}, the labels
    the JAX package gives the same parameters."""
    labels = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            parts = tuple(mname.split(".") if mname else ()) + (
                _flax_leaf(mod, pname),)
            key = f"{mname}.{pname}" if mname else pname
            if "drug_embeddings" in parts and "tx_encoder" in parts:
                labels[key] = "frozen"
                continue
            g = _group_of(parts)
            labels[key] = g if g == "decoder" else g + (
                "_nd" if _is_no_decay(parts) else "")
    return labels


def warmup_cosine_schedule(base_lr: float, warmup_epochs: int,
                           total_epochs: int, num_cycles: float = 1.0
                           ) -> Callable[[int], float]:
    """LinearWarmupCosineDecaySchedule (utils.py:665-679): linear 0 -> base
    over warmup, then base * (1 + cos(pi * cycles * t)) / 2."""

    def sched(step: int) -> float:
        if step < warmup_epochs:
            return base_lr * step / max(warmup_epochs, 1)
        t = (step - warmup_epochs) / max(total_epochs - warmup_epochs, 1)
        return base_lr * (1.0 + math.cos(math.pi * num_cycles * t)) / 2.0

    return sched


def create_optimizer(model: nn.Module, cfg: OptimizerConfig,
                     warmup_epochs: int = 0, total_epochs: int = 1,
                     frozen_encoder: bool = False):
    """(AdamW over the labelled groups, its per-epoch LambdaLR). With
    frozen_encoder only the decoder trains (reference --frozen,
    utils.py:329-331)."""
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer={cfg.optimizer!r}: only adamw is ported (ROADMAP: "
            "radam and lars optimizers)")
    group_lrs = {"str": cfg.structure_encoder_lr, "kg": cfg.kg_encoder_lr,
                 "perturb": cfg.perturb_encoders_lr, "fusion": cfg.fusion_lr,
                 "decoder": cfg.decoder_lr}
    labels = param_labels(model)
    params = dict(model.named_parameters())
    groups = []
    for g in GROUPS:
        if frozen_encoder and g != "decoder":
            continue
        for label, wd in ((g, cfg.wd), (g + "_nd", 0.0)):
            ps = [params[k] for k, lab in labels.items() if lab == label]
            if ps:
                groups.append({"params": ps, "lr": group_lrs[g],
                               "weight_decay": wd, "label": label})
    opt = torch.optim.AdamW(groups, betas=(cfg.beta1, cfg.beta2),
                            eps=cfg.eps)
    factor = (warmup_cosine_schedule(1.0, warmup_epochs, total_epochs)
              if warmup_epochs > 0 else (lambda step: 1.0))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
