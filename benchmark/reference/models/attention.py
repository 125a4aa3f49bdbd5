"""Multi-head attention and transformer encoder layers (port of
`madrigal_tpu/models/attention.py`; torch.nn.MultiheadAttention /
TransformerEncoderLayer semantics, batch first).

Plain matmul + softmax: the fusion sequence is ~21 tokens, and the JAX
package has no attention kernel either. Masked logits are set to -1e9, so
a fully masked row gets uniform weights instead of NaN, as in the JAX
package.

With `remat`, each layer whose weights are not returned is recomputed in
the backward (`torch.utils.checkpoint`), under the JAX package's policies:
None recomputes everything, 'dots' keeps the outputs of the Linear layers
(the matmuls without batch dimensions, `mm` / `addmm`) and recomputes the
attention products, softmax and elementwise work, 'all' keeps everything
(no recompute inside the layer).

`compute_dtype='bfloat16'` is the JAX package's throughput mode
(attention.py:37-90, 105-132): the q/k/v/out projections and both
feed-forward Linears run on bf16 activations and bf16 copies of their
weights, the attention logits are taken in float32 from the bf16 q and k,
and the softmax, the returned weights, the LayerNorms and the residual
stream stay float32; the parameters stay float32. 'float32' (or None)
inserts no cast.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .mlp import activation
from .remat import remat

NEG_INF = -1e9


def reduced_dtype(compute_dtype) -> Optional[torch.dtype]:
    """None for None or 'float32' (no casts anywhere), else the torch
    dtype of a reduced compute type such as 'bfloat16'."""
    if compute_dtype in (None, "float32"):
        return None
    dtype = getattr(torch, compute_dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return dtype


def dense(lin: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`lin(x)`, or with a reduced `dtype` the flax Dense of that dtype:
    the product of the cast input and weight, rounded, then the cast bias
    added and rounded again."""
    if dtype is None:
        return lin(x)
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


def reduced_activation(actn: str):
    """The activation as JAX evaluates it on reduced-precision input: its
    exact GELU, 0.5 * x * erfc(-x * sqrt(1/2)), rounds after every
    operation (and its constant to the type); the other activations are
    one rounding either way."""
    if actn not in ("gelu", "gelu_exact"):
        return activation(actn)

    def gelu(x):
        return 0.5 * x * torch.special.erfc(
            -x * torch.tensor(0.5 ** 0.5, dtype=x.dtype))
    return gelu


class MultiheadAttention(nn.Module):
    """q/k/v/out projections as four Linear layers (the JAX head layout:
    head h owns features [h*D, (h+1)*D) of each projection)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 compute_dtype: str | None = "float32"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} % heads {num_heads}")
        self.dtype = reduced_dtype(compute_dtype)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                return_weights: bool = False):
        """query [B, Tq, E], key/value [B, Tk, E]; key_padding_mask
        [B, Tk] and attn_mask [Tq, Tk] are bool, True = disallowed."""
        B, Tq, E = query.shape
        Tk = key.shape[1]
        H = self.num_heads
        D = E // H
        dt = self.dtype
        q = dense(self.q_proj, query, dt).reshape(B, Tq, H, D).transpose(1, 2)
        k = dense(self.k_proj, key, dt).reshape(B, Tk, H, D).transpose(1, 2)
        v = dense(self.v_proj, value, dt).reshape(B, Tk, H, D).transpose(1, 2)
        if dt is None:
            logits = torch.matmul(q * (1.0 / math.sqrt(D)),
                                  k.transpose(-1, -2))
        else:
            # JAX scales by 1 / sqrt(D) taken in the compute type, and
            # takes the logits in float32 from the reduced q and k
            scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=dt))
            logits = torch.matmul((q * scale).float(),
                                  k.float().transpose(-1, -2))
        mask = torch.zeros((B, 1, Tq, Tk), dtype=torch.bool,
                           device=query.device)
        if key_padding_mask is not None:
            mask = mask | key_padding_mask[:, None, None, :]
        if attn_mask is not None:
            mask = mask | attn_mask[None, None, :, :]
        logits = logits.masked_fill(mask, NEG_INF)
        weights = torch.softmax(logits, dim=-1)
        weights = F.dropout(weights, self.dropout, self.training)
        out = torch.matmul(weights if dt is None else weights.to(dt), v)
        out = dense(self.out_proj, out.transpose(1, 2).reshape(B, Tq, E), dt)
        return (out, weights) if return_weights else out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, actn: str = "relu",
                 norm_first: bool = False,
                 compute_dtype: str | None = "float32"):
        super().__init__()
        self.dtype = reduced_dtype(compute_dtype)
        self.dropout = dropout
        self.norm_first = norm_first
        self.act = (activation(actn) if self.dtype is None
                    else reduced_activation(actn))
        self.self_attn = MultiheadAttention(d_model, nhead, dropout,
                                            compute_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def _drop(self, x):
        return F.dropout(x, self.dropout, self.training)

    def _up(self, x):
        """Back to the residual stream's float32 (no cast in float32
        mode)."""
        return x if self.dtype is None else x.float()

    def forward(self, x, key_padding_mask=None, attn_mask=None,
                return_weights: bool = False):
        weights = None

        def sa(h):
            nonlocal weights
            out = self.self_attn(h, h, h, key_padding_mask, attn_mask,
                                 return_weights=return_weights)
            if return_weights:
                out, weights = out
            return self._up(self._drop(out))

        def ff(h):
            dt = self.dtype
            return self._up(self._drop(dense(self.linear2, self._drop(
                self.act(dense(self.linear1, h, dt))), dt)))

        if self.norm_first:
            x = x + sa(self.norm1(x))
            x = x + ff(self.norm2(x))
        else:
            x = self.norm1(x + sa(x))
            x = self.norm2(x + ff(x))
        return (x, weights) if return_weights else x


class TransformerEncoder(nn.Module):
    """Stack of encoder layers (`layer_0`, ...); the last layer can return
    its attention weights. `remat` / `remat_policy`: see the module
    docstring."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int, dropout: float = 0.1,
                 actn: str = "relu", norm_first: bool = False,
                 remat: bool = False, remat_policy: str | None = None,
                 compute_dtype: str | None = "float32"):
        super().__init__()
        if remat_policy not in (None, "dots", "all"):
            raise ValueError(f"unknown remat_policy {remat_policy!r} "
                             "(None | 'dots' | 'all')")
        self.num_layers = num_layers
        self.remat = remat and remat_policy != "all"
        self.remat_policy = remat_policy
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, actn, norm_first,
                compute_dtype))

    def forward(self, x, key_padding_mask=None, attn_mask=None,
                return_last_attn: bool = False):
        last = None
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            want = return_last_attn and i == self.num_layers - 1
            if self.remat and not want:
                x = remat(layer, x, key_padding_mask, attn_mask,
                          policy=self.remat_policy)
                continue
            out = layer(x, key_padding_mask, attn_mask, return_weights=want)
            x, last = out if want else (out, last)
        return (x, last) if return_last_attn else x
