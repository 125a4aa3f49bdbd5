"""Cross-stage weight transfer, stage 1 -> stage 2 (port of
`madrigal_tpu/train/transfer.py`; reference pretrained-encoder loading,
models.py:219-230 str, 242-245 kg, 254-257 cv, 300-342 tx).

A stage-1 checkpoint (`cli/modality_pretrain.py`) is a state_dict under
`{str,kg,cv,tx}_encoder.`; a MadrigalEncoder's state_dict has the same
top-level names. The overlay keeps only the entries the encoder declares,
which drops what stage 1 alone trains: the link-prediction heads of the
non-drug node types and the chemCPA decoder and adversaries, with their
BatchNorm statistics (the reference's key filter, models.py:309-312).
Parameters and statistics are both taken, as the JAX package overlays
`params` and `batch_stats`. Composes with `train/checkpoint.py`'s
stage-2 -> stage-3 warm start for the 3-stage pipeline.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from .checkpoint import merge_params


def _kept(target: Mapping[str, torch.Tensor], prefix: str,
          src: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`src`'s entries, renamed under `prefix`, that `target` declares."""
    return {prefix + k: v for k, v in src.items() if prefix + k in target}


def overlay_stage1_checkpoint(encoder_sd: Mapping[str, torch.Tensor],
                              stage1_sd: Mapping[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """`encoder_sd` (a MadrigalEncoder's state_dict) with a stage-1
    checkpoint's state_dict overlaid: each of its `{mod}_encoder`
    subtrees must name a module of the encoder (KeyError otherwise), and
    within it only the entries the encoder declares are taken (a shape
    mismatch raises ValueError)."""
    tops = {k.split(".")[0] for k in encoder_sd}
    for k in stage1_sd:
        if k.split(".")[0] not in tops:
            raise KeyError(f"checkpoint subtree '{k.split('.')[0]}' not in "
                           "encoder")
    return merge_params(encoder_sd, _kept(encoder_sd, "", stage1_sd))


def encoder_params_from_stage1(encoder_sd: Mapping[str, torch.Tensor],
                               str_pretrainer=None, kg_pretrainer=None,
                               cv_pretrainer=None, tx_pretrainer=None
                               ) -> Dict[str, torch.Tensor]:
    """`encoder_sd` with the stage-1 trainers' weights overlaid:

    * str: GINPretrainer's GIN (parameters and statistics);
    * kg: HGTLinkPredTrainer's HGT convs and drug head (the other node
      types' heads are dropped: the DDI encoder's head is drug-only);
    * cv: TabularAETrainer's encoder MLP;
    * tx: ChemCPAAdaptTrainer's encoder, embeddings and dosers, with their
      statistics (decoder and adversaries dropped).

    The JAX function also adds the chemCPA decoder's BatchNorm statistics
    to the tx subtree, where the encoder never reads them; a torch module
    has no slot for them."""
    sd = dict(encoder_sd)
    for mod, trainer, attr in (("str", str_pretrainer, "encoder_params"),
                               ("kg", kg_pretrainer, "encoder_params"),
                               ("cv", cv_pretrainer, "encoder_params"),
                               ("tx", tx_pretrainer, "encoder_variables")):
        if trainer is not None:
            sd = merge_params(sd, _kept(sd, f"{mod}_encoder.",
                                        getattr(trainer, attr)()))
    return sd
