"""Contrastive (SimCLR) pretraining loop, stage 2 (port of
`madrigal_tpu/train/pretrain_cl.py`; reference pretrain.py:41-292).

Drugs with at least 2 modalities; per-step drug choice and modality-subset
masks drawn on the host from `np.random.RandomState(cfg.seed)` in the JAX
trainer's order (`train/pretrain_masks.py`), so the draws equal its own;
the shared encoder's two-view forward, InfoNCE, and an AdamW step
at `pretrain_lr * batch / 512` (pretrain.py:173) on a per-step half-cycle
cosine schedule. The chemCPA `drug_embeddings` table (frozen rdkit2D
descriptors in the reference, chemCPA/embedding.py:10-20) gets no update
and no decay, as `optax.set_to_zero` gives it; every other parameter is
decayed, as `optax.adamw` with no mask does.

The whole drug table is collated onto the device once and each step
gathers its rows by id (`models/simclr.py`); the host sends the ids and
two masks (the port's `device_table` path, the only one kept here).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import PretrainConfig
from ..data.collate import DDICollator
from ..data.kg import HeteroKGBatch
from ..data.pipeline import to_device
from ..models.simclr import SimCLRModel
from .optim import half_cycle_cosine_schedule
from .pretrain_masks import get_pretrain_masks, sample_pretrain_masks


def is_frozen(name: str) -> bool:
    """The chemCPA drug_embeddings table under tx_encoder."""
    return {"drug_embeddings", "tx_encoder"} <= set(name.split("."))


def build_simclr_model(cfg: PretrainConfig, kg_node_dims, kg_edge_types
                       ) -> SimCLRModel:
    """The stage-2 model of `cfg` for a KG schema, on the CPU."""
    return SimCLRModel(cfg.encoder, kg_node_dims, kg_edge_types,
                       mlp_dim=cfg.moco_mlp_dim, temperature=cfg.moco_t,
                       shared_predictor=cfg.shared_predictor,
                       raw_encoder_output=cfg.raw_encoder_output)


class CLPretrainer:
    """Stage-2 trainer of `model` (a SimCLRModel from build_simclr_model,
    moved to the collator's device) over `collator`'s drugs and the KG
    batch `kg`. Optimizer state starts fresh."""

    def __init__(self, cfg: PretrainConfig, collator: DDICollator,
                 kg: HeteroKGBatch, model: SimCLRModel,
                 drug_ids: Optional[np.ndarray] = None,
                 device_table: bool = True):
        if not device_table:
            raise NotImplementedError("the host-collated minibatch")
        self.cfg = cfg
        self.collator = collator
        self.kg = kg
        self.device = collator.device
        self.model = model.train()
        ds = collator.ds
        masks = np.asarray(ds.masks)
        if drug_ids is None:
            # drugs with >= 2 modalities (reference data.py:280-284)
            drug_ids = np.where((1 - masks).sum(axis=1) >= 2)[0]
        self.drug_ids = np.asarray(drug_ids)
        self.width = masks.shape[1]
        self.mask_banks = get_pretrain_masks(
            self.drug_ids, masks[self.drug_ids], cfg.pretrain_mode,
            cfg.pretrain_unbalanced, cfg.pretrain_tx_downsample_ratio)
        self.np_rng = np.random.RandomState(cfg.seed)
        self.batch_size = min(cfg.pretrain_batch_size, len(self.drug_ids))
        # the JAX trainer draws one batch's masks to initialize its model;
        # drawing them here keeps the host streams equal
        self._sample_masks(self.drug_ids[:self.batch_size])

        self.full_batch = collator.drug_batch(np.arange(ds.num_drugs))

        lr = cfg.pretrain_lr * self.batch_size / 512.0
        self.params = [p for n, p in model.named_parameters()
                       if not is_frozen(n)]
        if cfg.pretrain_optimizer != "adamw":
            raise NotImplementedError(cfg.pretrain_optimizer)
        self.optimizer = torch.optim.AdamW(
            self.params, lr=lr, betas=(cfg.pretrain_beta1, cfg.pretrain_beta2),
            eps=cfg.pretrain_eps, weight_decay=cfg.pretrain_wd)
        # update k uses the schedule at k (the first at 0), as optax counts
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, half_cycle_cosine_schedule(
                1.0, cfg.warmup_epochs, cfg.pretrain_num_epochs))
        self.step = 0

    def _sample_masks(self, drugs):
        return sample_pretrain_masks(
            self.mask_banks, drugs, self.cfg.pretrain_mode,
            self.cfg.pretrain_unbalanced, self.np_rng, self.width)

    def _host_batch(self):
        """One step's host payload: (ids, m1, m2), numpy."""
        ids = (self.np_rng.choice(self.drug_ids, self.batch_size,
                                  replace=False)
               if len(self.drug_ids) > self.batch_size else self.drug_ids)
        m1, m2 = self._sample_masks(ids)
        return ids.astype(np.int32), m1, m2

    def _run_step(self, payload) -> torch.Tensor:
        """One optimizer step on a device payload; the loss stays on the
        device."""
        ids, m1, m2 = payload
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        _, _, (_, _, loss) = self.model(self.full_batch, self.kg, m1, m2,
                                        ids=ids)
        loss.backward()
        for p in self.params:
            # a parameter the loss does not reach (the fusion transformer
            # under raw_encoder_output) gets a zero gradient, so it is
            # still decayed and its moments advance, as in optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return loss.detach()

    def train_step(self) -> float:
        """One step over a random drug batch, collated and moved
        synchronously; returns the loss."""
        return float(self._run_step(to_device(self._host_batch(),
                                              self.device)))
