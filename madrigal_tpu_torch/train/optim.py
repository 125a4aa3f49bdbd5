"""Optimizer and schedule of stage-3 training (port of
`madrigal_tpu/train/optim.py`; reference madrigal/utils.py:446-694).

Five learning rates (structure / kg / perturb / fusion / decoder), each
with a no-decay twin ('<group>_nd': biases, LayerNorm scales, the learned
tokens, GIN eps and learned positions), as parameter groups of AdamW,
RAdam or LARS (`optim.optimizer`); the chemCPA `drug_embeddings` table is
'frozen' and in no group. The labels
are the JAX package's, read off each parameter's flax path: a torch
parameter's path is its module path with the leaf renamed back (a Linear
weight is a flax `kernel`, an Embedding weight an `embedding`, a norm
weight a `scale`).

The schedule is linear warmup then cosine decay, per epoch, as a
LambdaLR: one optimizer step is one epoch, and update k uses the
schedule at k (the first update at 0), as optax counts.

RAdam and LARS are written here, to the JAX package's arithmetic:
`optax.radam` after `optax.add_decayed_weights(wd)` (an L2 term on the
gradient; `torch.optim.RAdam` adds eps to sqrt(v) before the bias
correction, optax after it, and tests its threshold with > where optax
uses >=), and the reference's moco-v3 LARS (utils.py:628-662).
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


def half_cycle_cosine_schedule(base_lr: float, warmup_epochs: int,
                               total_epochs: int) -> Callable[[int], float]:
    """The pretrain per-epoch adjust_learning_rate (utils.py:682-694):
    linear 0 -> base over warmup, then base * (1 + cos(pi * t)) / 2."""

    def sched(step: int) -> float:
        if step < warmup_epochs:
            return base_lr * step / max(warmup_epochs, 1)
        t = (step - warmup_epochs) / max(total_epochs - warmup_epochs, 1)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t))

    return sched


class RAdam(torch.optim.Optimizer):
    """optax.radam (threshold 5.0) after an L2 term `weight_decay * p` on
    the gradient, as the JAX package chains `add_decayed_weights`:
    m, v the moments of g + wd * p; at step t, m_hat = m / (1 - b1^t),
    v_hat = v / (1 - b2^t), rho = rho_inf - 2 t b2^t / (1 - b2^t); the
    update is lr * r * m_hat / (sqrt(v_hat) + eps) when rho >= 5, else
    lr * m_hat."""

    threshold = 5.0

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, eps, lr = group["weight_decay"], group["eps"], group["lr"]
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + wd * p if wd else p.grad
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                m_hat = m / (1.0 - b1 ** t)
                b2t = b2 ** t
                rho = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
                if rho >= self.threshold:
                    r = math.sqrt((rho - 4.0) * (rho - 2.0) * rho_inf
                                  / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho))
                    v_hat = v / (1.0 - b2t)
                    m_hat = r * m_hat / (v_hat.sqrt() + eps)
                p.add_(m_hat, alpha=-lr)


class LARS(torch.optim.Optimizer):
    """LARS as the reference's moco-v3 copy (utils.py:628-662): for a
    parameter of more than one dimension, dp = (g + wd * p) * q with the
    trust ratio q = trust_coefficient * |p| / |g + wd * p| (1 where
    either norm is 0); other parameters take dp = g. Heavy-ball momentum
    mu = momentum * mu + dp, and p -= lr * mu, lr the group's rate at this
    step.

    `shard_groups` maps a parameter that is one shard of a larger tensor
    (the label-sharded decoder weight, `parallel/train_step.py`) to the
    process group holding its shards: its two norms are then those of
    the whole tensor, so the trust ratio is the unsharded one."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient))
        self.shard_groups = {}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            wd, lr = group["weight_decay"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                dp = p.grad
                if p.ndim > 1:
                    dp = dp + wd * p
                    pg = self.shard_groups.get(p)
                    if pg is None:
                        p_norm, g_norm = p.norm(), dp.norm()
                    else:
                        from ..parallel.collectives import all_reduce_

                        sq = torch.stack([p.square().sum(),
                                          dp.square().sum()])
                        p_norm, g_norm = all_reduce_(sq, group=pg).sqrt()
                    q = torch.where(
                        (p_norm > 0) & (g_norm > 0),
                        group["trust_coefficient"] * p_norm / g_norm,
                        torch.ones_like(p_norm))
                    dp = dp * q
                st = self.state[p]
                if "mu" not in st:
                    st["mu"] = torch.zeros_like(p)
                mu = st["mu"]
                mu.mul_(group["momentum"]).add_(dp)
                p.add_(mu, alpha=-lr)


def create_optimizer(model: nn.Module, cfg: OptimizerConfig,
                     warmup_epochs: int = 0, total_epochs: int = 1,
                     frozen_encoder: bool = False):
    """(cfg.optimizer over the labelled groups, its per-epoch LambdaLR).
    With frozen_encoder only the decoder trains (reference --frozen,
    utils.py:329-331)."""
    if cfg.optimizer not in ("adamw", "radam", "lars"):
        raise NotImplementedError(f"optimizer={cfg.optimizer!r}")
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
    if cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(groups, betas=(cfg.beta1, cfg.beta2),
                                eps=cfg.eps)
    elif cfg.optimizer == "radam":
        opt = RAdam(groups, lr=cfg.decoder_lr, betas=(cfg.beta1, cfg.beta2),
                    eps=cfg.eps)
    else:
        opt = LARS(groups, lr=cfg.decoder_lr, momentum=cfg.momentum)
    factor = (warmup_cosine_schedule(1.0, warmup_epochs, total_epochs)
              if warmup_epochs > 0 else (lambda step: 1.0))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
