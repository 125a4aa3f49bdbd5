"""Mask-aware BatchNorm (port of `madrigal_tpu/models/norm.py`), eval mode.

Normalizes the last dimension with the running statistics, as
torch.nn.BatchNorm1d does in eval mode. Train-mode batch statistics
(masked rows left out, unbiased running-var update) belong to the
training port and raise here.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        del mask  # only train-mode statistics read it
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm train mode arrives with the training port "
                "(ROADMAP: stage-3 training); call model.eval()")
        y = (x - self.running_mean) / torch.sqrt(self.running_var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y
