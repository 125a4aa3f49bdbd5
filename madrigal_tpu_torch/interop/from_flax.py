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
`stage1_checkpoint_from_flax`; a JAX `LMDecoder`'s params load into the
port's (`models/lm_decoder.py`) through `lm_decoder_state_dict`.

The reference's own (upstream Madrigal) checkpoints come in through the
copies of the JAX package's converters (`interop/convert_checkpoint.py`,
`interop/torch_convert.py`), which give flax trees, and this module:
`state_dict_from_reference` for a finetune (stage-3) state_dict and
`stage2_checkpoint_from_reference` for a contrastive (stage-2) one.
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


def _checked_state_dict(variables: Mapping, model: str, tops) -> Dict[
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
    return _checked_state_dict(variables, "GINPropertyModel",
                               ("encoder", "head"))


def hgt_link_pred_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `HGTLinkPredTrainer`'s variables ({'params'} of
    `HGTLinkPredModel`: the HGT `encoder` with every node type's head, and
    the shared `decoder`) as the port's HGTLinkPredModel state_dict."""
    return _checked_state_dict(variables, "HGTLinkPredModel",
                               ("encoder", "decoder"))


def tabular_ae_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `TabularAETrainer`'s variables ({'params'} of `TabularAE`)
    as the port's TabularAE state_dict."""
    return _checked_state_dict(variables, "TabularAE", ("encoder", "decoder"))


def chemcpa_adapt_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `ChemCPAAdaptTrainer`'s variables ({'params', 'batch_stats'}
    of `ChemCPAEncoder` after `warmup`: with the decoder and, unless
    disable_adv, the adversaries) as the state_dict of the port's
    `ChemCPAEncoder(cfg, adaptation=True)`."""
    return _checked_state_dict(variables, "ChemCPAEncoder (stage 1)",
                               ("encoder", "decoder", "cov_embedding"))


def lm_decoder_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `LMDecoder`'s params (its `state.params` in
    `LMDecoderTrainer`, as numpy) as the port's LMDecoder state_dict."""
    return _checked_state_dict({"params": params}, "LMDecoder",
                               ("drug_project", "text_project", "out_dense1",
                                "out_dense2"))


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


def _unread_reference_entries(sd: Mapping[str, torch.Tensor], enc_cfg,
                              kg_metadata, prefix: str = "encoder.") -> set:
    """Entries of a converted reference state_dict that the port's model
    has no slot for and the reference never reads in its forward: the
    chemCPA decoder (a stage-1 head; the stage-3 encoder has none), and
    per HGT layer the PyG output Linear and skip gate of a node type that
    no edge type reaches (its input passes through), and the skip gate of
    one whose input width is not the hidden width (PyG applies it only
    when the widths match). The JAX model holds them in its tree and
    never reads them either. `prefix` is the encoder's."""
    drop = {k for k in sd if k.startswith(prefix + "tx_encoder.decoder.")}
    pre = prefix + "kg_encoder."
    if kg_metadata is None or not any(k.startswith(pre) for k in sd):
        return drop
    dst_types = {tuple(et)[2] for et in kg_metadata.edge_types}
    widths = {nt: int(sd[f"{pre}conv_0.kqv__{nt}.weight"].shape[1])
              for nt in kg_metadata.node_types}
    for i in range(enc_cfg.hgt.num_layers):
        for nt in kg_metadata.node_types:
            if nt not in dst_types:
                drop |= {f"{pre}conv_{i}.out__{nt}.weight",
                         f"{pre}conv_{i}.out__{nt}.bias"}
            if nt not in dst_types or widths[nt] != enc_cfg.hgt.hidden_dim:
                drop.add(f"{pre}conv_{i}.skip__{nt}")
        widths = {nt: (enc_cfg.hgt.hidden_dim if nt in dst_types else w)
                  for nt, w in widths.items()}
    return drop & set(sd)


def state_dict_from_reference(state_dict: Mapping, enc_cfg, kg_metadata
                              ) -> Dict[str, torch.Tensor]:
    """An upstream Madrigal finetune checkpoint's state_dict
    (NovelDDIMultilabel: `encoder.*` and the decoder's parametrized
    weight) as entries of the port's MadrigalMultilabel state_dict, which
    load with `model.load_state_dict(sd, strict=False)` as the reference
    loads with strict=False: the modules it holds are replaced, the
    others keep their fresh values (convert_checkpoint.py:36-37).

    `enc_cfg` is the port's EncoderConfig and `kg_metadata` the KG's
    (`HeteroKGBatch.metadata`; node and edge types). The HGT is read in
    the PyG 2.3 layout under softmax_scope='global' or the PyG <= 2.2
    layout under 'per_edge_type'; a layout whose scope does not match
    the config raises ValueError, and with `kg_metadata` a KG encoder in
    neither layout raises KeyError. Entries that the reference never
    reads and the port's model has no slot for are left out
    (`_unread_reference_entries`), so nothing the result holds is
    unexpected to the model."""
    from .convert_checkpoint import convert_reference_finetune_checkpoint

    params, stats = convert_reference_finetune_checkpoint(
        state_dict, enc_cfg, kg_metadata, strict_kg=kg_metadata is not None)
    sd = flax_to_state_dict({"params": params, "batch_stats": stats})
    drop = _unread_reference_entries(sd, enc_cfg, kg_metadata)
    return {k: v for k, v in sd.items() if k not in drop}


def stage2_checkpoint_from_reference(state_dict: Mapping, path: str, cfg,
                                     kg_metadata,
                                     use_pretrained_adaptor: bool = False
                                     ) -> None:
    """Write an upstream Madrigal contrastive (stage-2) checkpoint's
    state_dict (`base_encoder.*`) as a port stage-2 checkpoint that
    `cli.train_ddi --checkpoint` warm-starts from unchanged.

    The reference's CL -> finetune filter runs first
    (`convert_reference_cl_checkpoint`: the fusion modules, the
    positional encoding, the CLS and bottleneck tokens go, and the uni
    projector unless `use_pretrained_adaptor`; reference
    utils.py:281-296), then the encoder is written under `base_encoder`
    as `stage2_checkpoint_from_flax` writes a JAX run's, without the
    entries `state_dict_from_reference` leaves out. `cfg` is the run's
    config as the port's dataclass (a PretrainConfig, a TrainConfig or
    an EncoderConfig), from which the encoder's config is read;
    `kg_metadata` is the KG's, as for `state_dict_from_reference`."""
    from ..train.checkpoint import save_checkpoint
    from .convert_checkpoint import convert_reference_cl_checkpoint

    enc_cfg = getattr(cfg, "encoder", None) or getattr(
        getattr(cfg, "model", None), "encoder", None) or cfg
    params, stats = convert_reference_cl_checkpoint(
        state_dict, enc_cfg, kg_metadata, use_pretrained_adaptor)
    sd = flax_to_state_dict({"params": {"base_encoder": params},
                             "batch_stats": {"base_encoder": stats}})
    drop = _unread_reference_entries(sd, enc_cfg, kg_metadata,
                                     prefix="base_encoder.")
    save_checkpoint(path, {k: v for k, v in sd.items() if k not in drop},
                    cfg, epoch=0)
