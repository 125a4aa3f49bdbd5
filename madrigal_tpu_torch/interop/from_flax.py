"""Flax variable tree -> the port's state_dict.

The port's modules carry the flax module names (`encoder.kg_encoder.
conv_0.kqv__drug`, `encoder.transformer.x_attn_mha.q_proj`, ...), so a
parameter's torch key is its flax path joined with '.', with the leaf
renamed:

  Dense `kernel` [in, out]        -> `weight` [out, in] (transposed)
  Embed `embedding`               -> `weight`
  BatchNorm / LayerNorm `scale`   -> `weight`
  batch_stats `mean` / `var`      -> `running_mean` / `running_var`

Everything else keeps its name and layout: `bias`, GIN `eps`, the HGT
per-relation `k_rel__*` / `v_rel__*` [H, D, D], `p_rel__*` [H] and
`skip__*` [1], attention q/k/v/out projections (heads stay the
contiguous D-wide feature blocks of the JAX layout), learned tokens, and
the decoder's unsymmetrized `weight` [L, D, D]. LayerNorm eps is 1e-5 in
both packages. A JAX `FinetuneTrainer`'s `params` and `batch_stats` load
into the port's `MadrigalMultilabel` the same way, for eval or train
mode (`models/norm.py` keeps each BatchNorm's train-mode rule).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_LEAF = {"scale": "weight", "embedding": "weight", "mean": "running_mean",
         "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def flax_to_state_dict(variables: Mapping, prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """`variables` is {'params': ..., 'batch_stats': ...} as nested dicts
    of arrays, or flat '/'-joined path keys ('params/encoder/...', the
    layout of tests/golden/tiny_model_v1.npz); other flat keys are
    skipped. `prefix` is prepended to every torch key."""
    if any("/" in str(k) for k in variables):
        paths = {tuple(k.split("/")): np.asarray(variables[k])
                 for k in variables
                 if k.split("/")[0] in ("params", "batch_stats")}
    else:
        paths = _flatten(variables)
    sd = {}
    for path, value in paths.items():
        collection, *names = path
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unknown collection {collection!r}")
        if names[-1] == "kernel":
            if value.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: Dense kernel of "
                                 f"rank {value.ndim}")
            value = value.T
        sd[prefix + torch_key(names)] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C"))
    return sd


def torch_key(names) -> str:
    """The port's state_dict key of a flax variable path (collection
    dropped), e.g. ('encoder', 'cv_encoder', 'dense_0', 'kernel') ->
    'encoder.cv_encoder.dense_0.weight'."""
    leaf = "weight" if names[-1] == "kernel" else _LEAF.get(names[-1],
                                                            names[-1])
    return ".".join(list(names[:-1]) + [leaf])


def load_flax_weights(module: torch.nn.Module, variables: Mapping,
                      prefix: str = "") -> torch.nn.Module:
    """Copy a flax variable tree into `module`; every parameter and
    buffer must be matched exactly."""
    sd = flax_to_state_dict(variables, prefix)
    module.load_state_dict(sd, strict=True)
    return module
