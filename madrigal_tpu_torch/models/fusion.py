"""Missing-modality-masked transformer fusion and positional encodings
(port of `madrigal_tpu/models/fusion.py`; reference models.py:352-455,
551-603).

With `cfg.remat` the whole fusion call is recomputed in the backward, so
only its embed-width inputs are kept between the forward and the backward
(as the JAX encoder wraps `TransformerFusion` in `nn.remat`), and inside
that recompute each transformer layer is rematerialized under
`cfg.remat_policy` (`models/attention.py`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import FusionConfig
from ..ops.segment import masked_max_pool, masked_mean_pool
from .attention import MultiheadAttention, TransformerEncoder
from .remat import remat


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """Standard sinusoidal table [1, max_len, d_model] (models.py:560-568)."""
    position = np.arange(max_len)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None]


class PositionEncoding(nn.Module):
    """Adds a positional encoding to the first `max_len` tokens; later
    tokens (bottleneck and tx tokens) get none. pe_type 'learnable' (a
    parameter) or 'sinusoidal' (a fixed table, not saved)."""

    def __init__(self, max_len: int, d_model: int,
                 pe_type: str = "learnable", dropout: float = 0.1):
        super().__init__()
        self.max_len, self.dropout = max_len, dropout
        if pe_type == "learnable":
            self.pe = nn.Parameter(torch.empty(1, max_len, d_model))
        elif pe_type == "sinusoidal":
            self.register_buffer(
                "pe", torch.from_numpy(sinusoidal_pe(max_len, d_model)),
                persistent=False)
        else:
            raise NotImplementedError(pe_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = min(x.shape[1], self.max_len)
        pe = F.pad(self.pe[:, :n], (0, 0, 0, x.shape[1] - n))
        return F.dropout(x + pe, self.dropout, self.training)


class TransformerFusion(nn.Module):
    """Masked fusion transformer with 'mean' | 'max' | 'cls' | 'x-attn'
    aggregation. Inputs: fusion_sequence [B, S, embed_dim], fusion_mask
    [B, S] bool (True = missing), src_mask [S, S] bool (True = disallowed).
    Output [B, embed_dim]."""

    def __init__(self, cfg: FusionConfig, embed_dim: int, num_kv_tokens: int,
                 num_non_tx: int):
        super().__init__()
        if cfg.compute_dtype not in (None, "float32"):
            raise NotImplementedError(
                f"transformer.compute_dtype={cfg.compute_dtype!r}: the bf16 "
                "fusion path is not ported yet (ROADMAP)")
        if cfg.agg not in ("x-attn", "cls", "mean", "max"):
            raise NotImplementedError(cfg.agg)
        self.cfg = cfg
        latent = cfg.latent_dim
        self.embed2latent = nn.Linear(embed_dim, latent)
        self.transformer_encoder = TransformerEncoder(
            cfg.num_layers, latent, cfg.att_heads, cfg.ffn_dim, cfg.dropout,
            cfg.actn, cfg.norm_first, remat=cfg.remat,
            remat_policy=cfg.remat_policy)
        if cfg.agg == "x-attn":
            self.x_attn_query = nn.Parameter(torch.empty(1, latent))
            self.x_attn_kv_norm = nn.LayerNorm(latent, eps=1e-5)
            self.x_attn_query_norm = nn.LayerNorm(latent, eps=1e-5)
            self.x_attn_mha = MultiheadAttention(latent, cfg.att_heads,
                                                 cfg.dropout)
            # with bottlenecks the pooling query reads only them
            kpm = torch.zeros(num_kv_tokens, dtype=torch.bool)
            if cfg.num_tx_bottlenecks > 0:
                kpm[:num_non_tx] = True
                kpm[num_non_tx + cfg.num_tx_bottlenecks:] = True
            self.register_buffer("x_attn_kpm", kpm, persistent=False)
        self.latent2embed = nn.Linear(latent, embed_dim)

    def forward(self, fusion_sequence, fusion_mask, src_mask=None,
                return_last_attn: bool = False):
        if self.cfg.remat and not return_last_attn:
            return remat(self._forward, fusion_sequence, fusion_mask,
                         src_mask)
        return self._forward(fusion_sequence, fusion_mask, src_mask,
                             return_last_attn)

    def _forward(self, fusion_sequence, fusion_mask, src_mask=None,
                 return_last_attn: bool = False):
        cfg = self.cfg
        B = fusion_sequence.shape[0]
        h = self.embed2latent(fusion_sequence)
        enc = self.transformer_encoder(h, fusion_mask, src_mask,
                                       return_last_attn=return_last_attn)
        h, last_attn = enc if return_last_attn else (enc, None)

        if cfg.agg == "x-attn":
            q = self.x_attn_query[None].expand(B, 1, -1)
            kpm = self.x_attn_kpm[None].expand(B, -1)
            kv = self.x_attn_kv_norm(h)
            if cfg.norm_first:
                q = self.x_attn_query_norm(q)
            out = self.x_attn_mha(q, kv, kv, key_padding_mask=kpm)
            out = F.dropout(out, cfg.dropout, self.training) + q
            if not cfg.norm_first:
                out = self.x_attn_query_norm(out)
            pooled = self.latent2embed(out[:, 0])
        else:
            h = self.latent2embed(h)
            if cfg.agg == "cls":
                pooled = h[:, 0]
            elif cfg.agg == "mean":
                pooled = masked_mean_pool(h, ~fusion_mask)
            else:
                pooled = masked_max_pool(h, ~fusion_mask)
        return (pooled, last_attn) if return_last_attn else pooled


def build_bottleneck_masks(num_non_tx: int, num_bottlenecks: int,
                           num_cell_lines: int, with_cls: bool) -> np.ndarray:
    """Structure mask isolating tx tokens behind bottlenecks
    (models.py:813-842); True = attention disallowed. Token order:
    [CLS?] + non-tx + bottlenecks + tx."""
    s = num_non_tx + num_bottlenecks + num_cell_lines
    m = np.zeros((s, s), dtype=bool)
    m[:num_non_tx, -num_cell_lines:] = True  # non-tx cannot see tx
    m[-num_cell_lines:, :num_non_tx] = True  # tx cannot see non-tx
    if with_cls:
        # CLS attends to (and is attended by) everything (models.py:829-842)
        m = np.pad(m, ((1, 0), (1, 0)), constant_values=False)
    return m
