"""Contrastive (SimCLR) pretraining loop, stage 2 (port of
`madrigal_tpu/train/pretrain_cl.py`; reference pretrain.py:41-292).

Drugs with at least 2 modalities; per-step drug choice and modality-subset
masks drawn on the host from `np.random.RandomState(cfg.seed)` in the JAX
trainer's order (`train/pretrain_masks.py`), so the draws equal its own;
the shared encoder's two-view forward, InfoNCE, and an AdamW or LARS step
at `pretrain_lr * batch / 512` (pretrain.py:173) on a per-step half-cycle
cosine schedule. The chemCPA `drug_embeddings` table (frozen rdkit2D
descriptors in the reference, chemCPA/embedding.py:10-20) gets no update
and no decay, as `optax.set_to_zero` gives it; every other parameter is
decayed, as `optax.adamw` with no mask does.

By default (`device_table`) the whole drug table is collated onto the
device once and each step gathers its rows by id (`models/simclr.py`);
the host sends the ids and two masks. Otherwise each step's minibatch is
collated on the host. `train_steps` builds step t+1's host payload on a
prefetch thread while the device runs step t (`data/pipeline.py`), with
the losses of as many `train_step` calls.

`parallel/train_step.shard_cl_pretrainer` splits the batch over 'dp'
through three seams left None here: `row_slice` (the rank's rows of each
step's draws: every rank draws the whole batch, so the host streams stay
the single device's), `_kg_table_fn` (the graph-parallel KG pass) and
`_reduce_grads` (the gradients' all-reduce before the optimizer step).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import PretrainConfig
from ..data.collate import DDICollator
from ..data.kg import HeteroKGBatch
from ..data.pipeline import prefetch_epochs, to_device
from ..models.simclr import SimCLRModel
from ..utils.profiling import span
from .optim import LARS, half_cycle_cosine_schedule
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

        self.full_batch = (collator.drug_batch(np.arange(ds.num_drugs))
                           if device_table else None)
        # host-collate batches are built on the CPU and moved by the
        # prefetcher (or to_device)
        self.host_collator = (None if device_table else DDICollator(
            ds, split=collator.split, device="cpu"))

        lr = cfg.pretrain_lr * self.batch_size / 512.0
        self.params = [p for n, p in model.named_parameters()
                       if not is_frozen(n)]
        if cfg.pretrain_optimizer == "adamw":
            self.optimizer = torch.optim.AdamW(
                self.params, lr=lr, betas=(cfg.pretrain_beta1,
                                           cfg.pretrain_beta2),
                eps=cfg.pretrain_eps, weight_decay=cfg.pretrain_wd)
        elif cfg.pretrain_optimizer == "lars":
            self.optimizer = LARS(self.params, lr=lr,
                                  weight_decay=cfg.pretrain_wd,
                                  momentum=cfg.pretrain_momentum)
        else:
            raise NotImplementedError(cfg.pretrain_optimizer)
        # update k uses the schedule at k (the first at 0), as optax counts
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, half_cycle_cosine_schedule(
                1.0, cfg.warmup_epochs, cfg.pretrain_num_epochs))
        self.step = 0
        # the sharding seams (parallel/train_step.py)
        self.row_slice = None
        self._kg_table_fn = None
        self._reduce_grads = None

    def _sample_masks(self, drugs):
        return sample_pretrain_masks(
            self.mask_banks, drugs, self.cfg.pretrain_mode,
            self.cfg.pretrain_unbalanced, self.np_rng, self.width)

    def _host_batch(self):
        """One step's host payload, numpy or CPU tensors: (ids, m1, m2) on
        the device-table path, (minibatch, m1, m2) otherwise."""
        ids = (self.np_rng.choice(self.drug_ids, self.batch_size,
                                  replace=False)
               if len(self.drug_ids) > self.batch_size else self.drug_ids)
        m1, m2 = self._sample_masks(ids)
        if self.row_slice is not None:
            ids, m1, m2 = (a[self.row_slice] for a in (ids, m1, m2))
        if self.full_batch is not None:
            return ids.astype(np.int32), m1, m2
        return self.host_collator.drug_batch(ids), m1, m2

    def _run_step(self, payload) -> torch.Tensor:
        """One optimizer step on a device payload; the loss stays on the
        device."""
        batch_or_ids, m1, m2 = payload
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with span("madrigal.forward"):
            table = (None if self._kg_table_fn is None
                     else self._kg_table_fn(self.kg))
            if self.full_batch is not None:
                _, _, (_, _, loss) = self.model(
                    self.full_batch, self.kg, m1, m2, kg_drug_table=table,
                    ids=batch_or_ids)
            else:
                _, _, (_, _, loss) = self.model(batch_or_ids, self.kg, m1,
                                                m2, kg_drug_table=table)
        with span("madrigal.backward"):
            loss.backward()
        with span("madrigal.optimizer"):
            for p in self.params:
                # a parameter the loss does not reach (the fusion
                # transformer under raw_encoder_output) gets a zero
                # gradient, so it is still decayed and its moments advance,
                # as in optax
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self._reduce_grads is not None:
                self._reduce_grads()
            self.optimizer.step()
            self.scheduler.step()
        self.step += 1
        return loss.detach()

    def train_step(self) -> float:
        """One step over a random drug batch, collated and moved
        synchronously; returns the loss."""
        with span("madrigal.draw"):
            payload = to_device(self._host_batch(), self.device)
        return float(self._run_step(payload))

    def train_steps(self, num_steps: int, buffer_size: int = 2
                    ) -> List[float]:
        """`num_steps` steps with the host payloads prefetched; the losses
        are read back once, at the end. The same draws and losses as
        `num_steps` calls of train_step."""
        losses = [self._run_step(payload) for payload in prefetch_epochs(
            lambda _s: self._host_batch(), num_steps, buffer_size,
            self.device)]
        return [float(l) for l in losses]

    def encoder_state_dict(self) -> dict:
        """The `base_encoder` entries (parameters and BatchNorm
        statistics), their prefix removed: what stage 3 warm-starts
        from."""
        return self.model.base_encoder.state_dict()

    def training_state(self) -> dict:
        """Optimizer and schedule state, for a checkpoint."""
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_training_state(self, state: dict, step: int) -> None:
        """Resume after `step` steps. The host draws restart from the
        seed, as the JAX CLI's do."""
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = step
