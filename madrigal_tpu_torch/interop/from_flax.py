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
mode (`models/norm.py` keeps each BatchNorm's train-mode rule), and a JAX
stage-2 `CLPretrainer`'s into the port's `SimCLRModel` (`base_encoder.*`,
`predictor.*` or `predictor_1.*` / `predictor_2.*`; the last BatchNorm of
a predictor has statistics and no scale or bias, on both sides). The
JAX stage-1 trainers' variables load into the port's stage-1 models
(`train/modality_pretrain.py`) through the `*_state_dict` functions below,
and a JAX stage-1 checkpoint becomes a port one with
`stage1_checkpoint_from_flax`.
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


def stage2_checkpoint_from_flax(variables: Mapping, path: str, cfg,
                                epoch: int = 0) -> None:
    """Write a JAX stage-2 (contrastive pretraining) run's variables as a
    port checkpoint that `cli.train_ddi --checkpoint` warm-starts from.

    `variables` is {'params': ..., 'batch_stats': ...} of the JAX
    package's SimCLR model as numpy (the encoder under `base_encoder`),
    and `cfg` the run's config as the port's dataclass. Every module is
    kept: `base_encoder` with the fusion modules and the uni projector
    that the warm start may drop, and the projection heads. The port's
    own stage-2 CLI (`cli.pretrain`) writes such a checkpoint itself; a
    JAX stage-2 run reaches the card this way, in a process that has the
    JAX package:

        tree, meta = madrigal_tpu.train.checkpoint.load_checkpoint(run)
        cfg = config.from_dict(getattr(config, meta["config_class"]),
                               meta["config"])
        stage2_checkpoint_from_flax(
            {"params": tree["params"],
             "batch_stats": tree.get("batch_stats", {})},
            "stage2.pt", cfg, epoch=meta["epoch"])

    (`config` is `madrigal_tpu_torch.config`.)"""
    from ..train.checkpoint import save_checkpoint

    save_checkpoint(path, flax_to_state_dict(variables), cfg, epoch=epoch)


def _stage1_state_dict(variables: Mapping, model: str, tops) -> Dict[
        str, torch.Tensor]:
    have = {k for coll in variables.values() for k in coll}
    if not set(tops) <= have:
        raise ValueError(f"not a JAX {model} variable tree: it lacks "
                         f"{sorted(set(tops) - have)} (has {sorted(have)})")
    return flax_to_state_dict(variables)


def gin_property_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `GINPretrainer`'s variables ({'params', 'batch_stats'} of
    `GINPropertyModel`: the GIN `encoder` and the task `head`) as the
    port's GINPropertyModel state_dict."""
    return _stage1_state_dict(variables, "GINPropertyModel",
                              ("encoder", "head"))


def hgt_link_pred_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `HGTLinkPredTrainer`'s variables ({'params'} of
    `HGTLinkPredModel`: the HGT `encoder` with every node type's head, and
    the shared `decoder`) as the port's HGTLinkPredModel state_dict."""
    return _stage1_state_dict(variables, "HGTLinkPredModel",
                              ("encoder", "decoder"))


def tabular_ae_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `TabularAETrainer`'s variables ({'params'} of `TabularAE`)
    as the port's TabularAE state_dict."""
    return _stage1_state_dict(variables, "TabularAE", ("encoder", "decoder"))


def chemcpa_adapt_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `ChemCPAAdaptTrainer`'s variables ({'params', 'batch_stats'}
    of `ChemCPAEncoder` after `warmup`: with the decoder and, unless
    disable_adv, the adversaries) as the state_dict of the port's
    `ChemCPAEncoder(cfg, adaptation=True)`."""
    return _stage1_state_dict(variables, "ChemCPAEncoder (stage 1)",
                              ("encoder", "decoder", "cov_embedding"))


def stage1_checkpoint_from_flax(tree: Mapping, path: str, cfg,
                                epoch: int = 0) -> None:
    """Write a JAX stage-1 checkpoint (`madrigal_tpu.cli.modality_pretrain`:
    its tree's 'params' and 'batch_stats' under `{str,kg,cv,tx}_encoder`)
    as a port stage-1 checkpoint, which `cli.pretrain --modality_ckpts`
    takes. `cfg` is the run's config as the port's dataclass (GINConfig,
    HGTConfig, MLPEncoderConfig or ChemCPAConfig); load the JAX one as
    `stage2_checkpoint_from_flax`'s docstring shows."""
    from ..train.checkpoint import save_checkpoint

    save_checkpoint(path, flax_to_state_dict(
        {"params": tree["params"],
         "batch_stats": tree.get("batch_stats") or {}}), cfg, epoch=epoch)
