"""MLP building blocks (port of `madrigal_tpu/models/mlp.py`).

  * `MLPEncoder` -- reference MLPEncoder / MLPAdaptor (models.py:121-180).
  * `ChemCPAMLP` -- chemCPA MLP (chemCPA/model.py:161-231), including the
    "half-ReLU" last-layer quirk.

Submodule names follow the flax modules (`dense_0`, `norm_0`, `bn_0`) so
that `interop/from_flax.py` maps parameters by path. Their BatchNorms
follow flax `nn.BatchNorm` in train mode (every row counts, biased
running variance; `models/norm.py`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .norm import MaskedBatchNorm

ACTIVATIONS = {
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "selu": F.selu,
    "softplus": F.softplus,
    # torch's nn.GELU default and the JAX package's "gelu": exact erf form
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    None: lambda x: x,
    "none": lambda x: x,
}


def activation(name: Optional[str]):
    return ACTIVATIONS[name]


class MLPEncoder(nn.Module):
    """Dense(in->h0), actn, then per further hidden dim [norm?, dropout?,
    Dense, actn] ('nd') or [dropout?, norm?, Dense, actn] ('dn'), then
    Dense(h_last->out)."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int],
                 output_dim: int, dropout: float = 0.0,
                 norm: Optional[str] = None, actn: str = "relu",
                 order: str = "nd"):
        super().__init__()
        if order not in ("nd", "dn"):
            raise NotImplementedError(order)
        if norm not in (None, "bn", "ln"):
            raise NotImplementedError(norm)
        self.act = activation(actn)
        self.dropout = dropout
        self.norm = norm
        self.order = order
        dims = [input_dim] + list(hidden_dims) + [output_dim]
        self.n_dense = len(dims) - 1
        for i in range(self.n_dense):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        for i in range(len(hidden_dims) - 1):
            if norm == "bn":
                self.add_module(f"norm_{i}", MaskedBatchNorm(
                    hidden_dims[i], flax_rule=True))
            elif norm == "ln":
                self.add_module(f"norm_{i}",
                                nn.LayerNorm(hidden_dims[i], eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.dense_0(x))
        for i in range(1, self.n_dense - 1):
            norm = getattr(self, f"norm_{i - 1}", None)
            if norm is not None and self.order == "nd":
                h = norm(h)
            h = F.dropout(h, self.dropout, self.training)
            if norm is not None and self.order == "dn":
                h = norm(h)
            h = self.act(getattr(self, f"dense_{i}")(h))
        return getattr(self, f"dense_{self.n_dense - 1}")(h)


class ChemCPAMLP(nn.Module):
    """`sizes` are the full layer widths, input and output included.
    BatchNorm + ReLU between all but the last Linear; last_layer_act
    'ReLU' applies ReLU to the first half of the outputs only."""

    def __init__(self, sizes: Sequence[int], batch_norm: bool = True,
                 last_layer_act: str = "linear"):
        super().__init__()
        if last_layer_act not in ("linear", "ReLU"):
            raise ValueError(last_layer_act)
        self.n = len(sizes) - 1
        self.batch_norm = batch_norm
        self.last_layer_act = last_layer_act
        for i in range(self.n):
            self.add_module(f"dense_{i}", nn.Linear(sizes[i], sizes[i + 1]))
            if i < self.n - 1 and batch_norm:
                self.add_module(f"bn_{i}", MaskedBatchNorm(
                    sizes[i + 1], flax_rule=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n):
            h = getattr(self, f"dense_{i}")(h)
            if i < self.n - 1:
                if self.batch_norm:
                    h = getattr(self, f"bn_{i}")(h)
                h = F.relu(h)
        if self.last_layer_act == "ReLU":
            dim = h.shape[-1] // 2
            h = torch.cat([F.relu(h[..., :dim]), h[..., dim:]], dim=-1)
        return h
