"""Batch normalization over the last dimension, in the JAX package's two
variants (port of `madrigal_tpu/models/norm.py::MaskedBatchNorm` and of
flax `nn.BatchNorm` as `models/mlp.py` uses it).

Eval mode normalizes with the running statistics, as
torch.nn.BatchNorm1d does. Train mode normalizes with the batch's biased
statistics and moves the running ones by momentum 0.1 (flax 0.9). The two
variants differ only there:

  * `MaskedBatchNorm` (the GIN's norm): statistics over the rows the mask
    keeps, and an unbiased running-variance update (var * n / (n - 1));
  * `flax_rule=True` (the MLP-family norms, flax `nn.BatchNorm`):
    statistics over every row, and the biased variance in the running
    update. torch.nn.BatchNorm1d would update with the unbiased one.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True,
                 momentum: float = 0.1, flax_rule: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.flax_rule = flax_rule
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.reshape(-1, x.shape[-1])
            if mask is None or self.flax_rule:
                count = xf.new_tensor(float(xf.shape[0]))
                mean = xf.mean(0)
                var = ((xf - mean) ** 2).mean(0)
            else:
                m = mask.reshape(-1, 1).to(x.dtype)
                count = m.sum().clamp_min(1.0)
                mean = (xf * m).sum(0) / count
                var = (((xf - mean) ** 2) * m).sum(0) / count
            with torch.no_grad():
                ra_var = var if self.flax_rule else (
                    var * count / (count - 1.0).clamp_min(1.0))
                k = self.momentum
                self.running_mean.mul_(1.0 - k).add_(k * mean)
                self.running_var.mul_(1.0 - k).add_(k * ra_var)
        y = (x - mean) / torch.sqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y
