"""SimCLR contrastive model of stage 2 (port of
`madrigal_tpu/models/simclr.py`; reference SimCLR_NovelDDI,
madrigal/models/simclr.py:11-141).

The shared MadrigalEncoder encodes the same drugs under two
modality-subset masks; one shared or two separate predictor heads
(`SimCLRPredictor`) project the views, and InfoNCE scores the 2B x 2B
similarity matrix. Submodule names are the flax ones (`base_encoder`,
`predictor` or `predictor_1` / `predictor_2`), so that
`interop/from_flax.py` carries a JAX run's variables across.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..config import EncoderConfig
from ..data.batch import DrugModalityBatch
from ..data.kg import EdgeType, HeteroKGBatch
from ..train.losses import info_nce
from .encoder import MadrigalEncoder
from .mlp import SimCLRPredictor


class SimCLRModel(nn.Module):
    def __init__(self, enc_cfg: EncoderConfig, kg_node_dims: Dict[str, int],
                 kg_edge_types: Sequence[EdgeType], mlp_dim: int = 512,
                 temperature: float = 0.1, shared_predictor: bool = False,
                 raw_encoder_output: bool = False):
        super().__init__()
        self.temperature = temperature
        self.shared_predictor = shared_predictor
        self.raw_encoder_output = raw_encoder_output
        self.base_encoder = MadrigalEncoder(enc_cfg, kg_node_dims,
                                            kg_edge_types)
        dim = enc_cfg.feature_dim
        if shared_predictor:
            self.predictor = SimCLRPredictor(dim, mlp_dim, dim)
        else:
            self.predictor_1 = SimCLRPredictor(dim, mlp_dim, dim)
            self.predictor_2 = SimCLRPredictor(dim, mlp_dim, dim)

    def forward(self, batch: DrugModalityBatch,
                kg: Optional[HeteroKGBatch], mask1: torch.Tensor,
                mask2: torch.Tensor, too_hard_neg_mask=None,
                kg_drug_table: Optional[torch.Tensor] = None,
                ids: Optional[torch.Tensor] = None):
        """(aug1, aug2, (logits, labels, loss)) (reference
        simclr.py:110-140). Train or eval mode is the module's.

        `kg_drug_table` skips the KG pass. With `ids` (the device-table
        path), `batch` is the whole drug table and the minibatch its rows
        `ids`: one modality-token pass over the table serves both views,
        which differ only where each view's mask fuses the gathered
        tokens. BatchNorm statistics of the modality encoders are then
        those of every drug, and any dropout draw is shared by the
        views, as in the JAX package. Without `ids`, `batch` is the
        minibatch, encoded once under each view's masks."""
        enc = self.base_encoder
        table = (kg_drug_table if kg_drug_table is not None
                 else enc.kg_drug_table(kg))
        raw = self.raw_encoder_output
        if ids is not None:
            tokens = enc.modality_tokens(batch, kg_drug_table=table)[
                ids.long()]
            z1 = enc.fuse_tokens(tokens, mask1, raw_encoder_output=raw)
            z2 = enc.fuse_tokens(tokens, mask2, raw_encoder_output=raw)
        else:
            z1 = enc.encode(dataclasses.replace(batch, masks=mask1),
                            kg_drug_table=table, raw_encoder_output=raw)
            z2 = enc.encode(dataclasses.replace(batch, masks=mask2),
                            kg_drug_table=table, raw_encoder_output=raw)
        if self.shared_predictor:
            aug1, aug2 = self.predictor(z1), self.predictor(z2)
        else:
            aug1, aug2 = self.predictor_1(z1), self.predictor_2(z2)
        return aug1, aug2, info_nce(aug1, aug2, self.temperature,
                                    too_hard_neg_mask)
