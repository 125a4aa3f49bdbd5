"""PyTorch-checkpoint -> JAX parameter converters (a copy of
`madrigal_tpu/interop/torch_convert.py`, numpy only; compose with
`interop/from_flax.flax_to_state_dict` to reach the port's state_dicts).

The reference ships/loads torch state_dicts for every component
(reference: madrigal/models/models.py:219-230 str encoder, 242-245 kg
encoder, 254-257 tabular encoders, 300-342 chemCPA tuple,
madrigal/utils.py:246-307 CL->finetune key filtering). These converters map
those state_dicts onto our flax trees so parity tests and warm-starts work.

torch Linear stores weight [out, in]; flax Dense kernel is [in, out].
All functions accept a dict of numpy/torch tensors and return
(params, batch_stats) nested dicts.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _dense(sd, prefix):
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _bn(sd, prefix, affine=True):
    params = {}
    if affine:
        params = {"scale": _np(sd[f"{prefix}.weight"]),
                  "bias": _np(sd[f"{prefix}.bias"])}
    stats = {
        "mean": _np(sd[f"{prefix}.running_mean"]),
        "var": _np(sd[f"{prefix}.running_var"]),
    }
    return params, stats


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


# ---------------------------------------------------------------------------
# GIN structure encoder (torchdrug GraphIsomorphismNetwork state_dict,
# e.g. modality_pretraining/str/GIN_256x4_muv.pt after prefix-stripping)
# ---------------------------------------------------------------------------

def convert_gin(sd: Dict, num_layers: int, num_mlp_layer: int = 3) -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for i in range(num_layers):
        layer = {
            "eps": _np(sd[f"layers.{i}.eps"]),
            "edge_linear": _dense(sd, f"layers.{i}.edge_linear"),
        }
        for j in range(num_mlp_layer):
            layer[f"mlp_{j}"] = _dense(sd, f"layers.{i}.mlp.layers.{j}")
        if f"layers.{i}.batch_norm.weight" in sd:
            bn_p, bn_s = _bn(sd, f"layers.{i}.batch_norm")
            layer["bn"] = bn_p
            stats[f"layer_{i}"] = {"bn": bn_s}
        params[f"layer_{i}"] = layer
    return params, stats


# ---------------------------------------------------------------------------
# MLPEncoder / MLPAdaptor (reference models.py:121-180 / 459-518)
# ---------------------------------------------------------------------------

def mlp_encoder_linear_positions(
    num_hidden: int, dropout: float, norm: Optional[str]
) -> Tuple[list, list]:
    """Re-derive the nn.Sequential positions of Linear and norm modules in the
    reference MLPEncoder layout (order='nd'). Returns (linear_idx, norm_idx)."""
    pos = 0
    linear_idx = [pos]  # input Linear
    pos += 2  # Linear, actn
    norm_idx = []
    for _ in range(num_hidden - 1):
        if norm is not None:
            norm_idx.append(pos)
            pos += 1
        if dropout and dropout > 0:
            pos += 1
        linear_idx.append(pos)
        pos += 2  # Linear, actn
    linear_idx.append(pos)  # output Linear
    return linear_idx, norm_idx


def convert_mlp_encoder(
    sd: Dict,
    hidden_dims,
    dropout: float,
    norm: Optional[str],
    prefix: str = "fc",
) -> Tuple[dict, dict]:
    linear_idx, norm_idx = mlp_encoder_linear_positions(
        len(hidden_dims), dropout, norm
    )
    params: dict = {}
    stats: dict = {}
    for k, idx in enumerate(linear_idx):
        params[f"dense_{k}"] = _dense(sd, f"{prefix}.{idx}")
    for k, idx in enumerate(norm_idx):
        if norm == "ln":
            params[f"norm_{k}"] = _ln(sd, f"{prefix}.{idx}")
        elif norm == "bn":
            bn_p, bn_s = _bn(sd, f"{prefix}.{idx}")
            params[f"norm_{k}"] = bn_p
            stats[f"norm_{k}"] = bn_s
    return params, stats


# ---------------------------------------------------------------------------
# chemCPA MLP (chemCPA/model.py:161-231): Sequential with integer names,
# Linear at even steps interleaved with BN (except after last Linear).
# ---------------------------------------------------------------------------

def convert_chemcpa_mlp(sd: Dict, num_linear: int, batch_norm: bool = True,
                        prefix: str = "network") -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    pos = 0
    for i in range(num_linear):
        params[f"dense_{i}"] = _dense(sd, f"{prefix}.{pos}")
        pos += 1
        if i < num_linear - 1:
            if batch_norm:
                bn_p, bn_s = _bn(sd, f"{prefix}.{pos}")
                params[f"bn_{i}"] = bn_p
                stats[f"bn_{i}"] = bn_s
                pos += 1
            pos += 1  # ReLU
    return params, stats


def filter_prefix(sd: Dict, prefix: str) -> Dict:
    """Select keys under `prefix.` and strip it."""
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def strip_torchdrug_model_prefix(sd: Dict) -> Dict:
    """Reference loader semantics for GIN_256x4_muv.pt
    (models.py:223-230): strip 'model.' and keep only 'layers.*'."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model."):
            k = k[len("model."):]
        if k.startswith("layer"):
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# torch.nn.MultiheadAttention / TransformerEncoder
# ---------------------------------------------------------------------------

def convert_mha(sd: Dict, prefix: str) -> dict:
    """Split torch's packed in_proj ([3E, E]) into q/k/v Dense params."""
    w = _np(sd[f"{prefix}.in_proj_weight"])
    b = _np(sd[f"{prefix}.in_proj_bias"])
    e = w.shape[1]
    return {
        "q_proj": {"kernel": w[:e].T, "bias": b[:e]},
        "k_proj": {"kernel": w[e : 2 * e].T, "bias": b[e : 2 * e]},
        "v_proj": {"kernel": w[2 * e :].T, "bias": b[2 * e :]},
        "out_proj": _dense(sd, f"{prefix}.out_proj"),
    }


def convert_transformer_layer(sd: Dict, prefix: str) -> dict:
    return {
        "self_attn": convert_mha(sd, f"{prefix}.self_attn"),
        "linear1": _dense(sd, f"{prefix}.linear1"),
        "linear2": _dense(sd, f"{prefix}.linear2"),
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "norm2": _ln(sd, f"{prefix}.norm2"),
    }


def convert_transformer_encoder(sd: Dict, num_layers: int,
                                prefix: str = "layers") -> dict:
    return {
        f"layer_{i}": convert_transformer_layer(sd, f"{prefix}.{i}")
        for i in range(num_layers)
    }


def convert_transformer_fusion(sd: Dict, num_layers: int, agg: str,
                               prefix: str = "") -> dict:
    """Reference TransformerFusion state dict (models.py:352-399) -> flax.

    Keys: embed2latent, transformer_encoder.layers.{i}.*, latent2embed,
    and for agg='x-attn': x_attn_kv_norm, x_attn_query_norm, x_attn_mha_layer,
    x_attn_query.
    """
    p = prefix + "." if prefix else ""
    out = {
        "embed2latent": _dense(sd, f"{p}embed2latent"),
        "latent2embed": _dense(sd, f"{p}latent2embed"),
        "transformer_encoder": convert_transformer_encoder(
            sd, num_layers, prefix=f"{p}transformer_encoder.layers"
        ),
    }
    if agg == "x-attn":
        out["x_attn_kv_norm"] = _ln(sd, f"{p}x_attn_kv_norm")
        out["x_attn_query_norm"] = _ln(sd, f"{p}x_attn_query_norm")
        out["x_attn_mha"] = convert_mha(sd, f"{p}x_attn_mha_layer")
        out["x_attn_query"] = _np(sd[f"{p}x_attn_query"])
    return out


# ---------------------------------------------------------------------------
# chemCPA TxAdaptingComPert (chemCPA/model.py:290-712). The reference loads a
# tuple (state_dict, opt, cov_embeddings_state_dicts, model_config, history)
# and side-loads covariate embeddings (models.py:300-342).
# ---------------------------------------------------------------------------

def convert_chemcpa(
    sd: Dict,
    cov_embedding_weight,
    encoder_depth: int = 2,
    embedding_encoder_depth: int = 3,
    dosers_depth: int = 4,
    use_drugs: bool = False,
    doser_type: str = "amortized",
    drug_embedding_weight=None,
) -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}

    for name, depth in (("encoder", encoder_depth), ("decoder", encoder_depth)):
        sub = filter_prefix(sd, name)
        p, s = convert_chemcpa_mlp(sub, num_linear=depth + 1)
        params[name] = p
        if s:
            stats[name] = s

    params["cov_embedding"] = {"embedding": _np(cov_embedding_weight)}

    if use_drugs:
        if drug_embedding_weight is not None:
            params["drug_embeddings"] = {"embedding": _np(drug_embedding_weight)}
        sub = filter_prefix(sd, "drug_embedding_encoder")
        p, s = convert_chemcpa_mlp(sub, num_linear=embedding_encoder_depth + 1)
        params["drug_embedding_encoder"] = p
        if s:
            stats["drug_embedding_encoder"] = s
        if doser_type == "amortized":
            sub = filter_prefix(sd, "dosers")
            p, s = convert_chemcpa_mlp(sub, num_linear=dosers_depth + 1)
            params["dosers"] = p
            if s:
                stats["dosers"] = s
        elif doser_type in ("sigm", "logsigm"):
            params["dosers"] = {
                "beta": _np(sd["dosers.beta"]),
                "bias": _np(sd["dosers.bias"]),
            }
    return params, stats
