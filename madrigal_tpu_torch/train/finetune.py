"""DDI finetune trainer, stage 3 (port of `madrigal_tpu/train/finetune.py`;
reference train_ddi_batch.py:45-418).

Full-batch training: the whole DDI table is one batch and one optimizer
step is one epoch. Each epoch samples per-drug modality-subset masks on
the host (`train/masking.py`, numpy-seeded, so the masks equal the JAX
package's), then runs the mode's one or three forwards (str-str directed
/ X-X directed / str-X undirected, train_ddi_batch.py:281-351) with
triple-gather scoring, and takes one multi-LR AdamW step.

Every step computes the KG drug table once, runs each forward against a
detached copy of it and backpropagates that forward at once, summing the
table's gradient across forwards, and ends with one KG backward for the
sum. This is the JAX package's `split_forward_grads` with
`split_share_kg_table`, which it shows equals its fused step
(finetune.py:282-295; tests/test_train.py::
test_split_share_kg_table_matches_unshared): the KG encoder has no
dropout and no batch statistics, and a gradient is linear in its
cotangent. It holds one forward's activations at a time, and the KG pass
runs forward and backward once per step, so kernel K2 runs once per step
for each (HGT layer, edge type) whose messages reach the drug table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..config import TrainConfig
from ..constants import NON_TX_MODALITIES
from ..data.collate import DDIBatch
from ..data.kg import HeteroKGBatch
from ..models.encoder import MadrigalMultilabel
from .losses import masked_bce
from .masking import FinetuneMasker
from .optim import create_optimizer


def label_chunk_view(batch: DDIBatch, chunk: int, align: int = 8192):
    """Label-chunked training view of a batch's triple list (JAX
    finetune.py:40-89): triples sorted by label, each label's run padded
    to a multiple of `chunk` with masked rows, the whole padded to a
    multiple of `align`. Every aligned chunk then shares one label, and
    the decoder gathers each [D, D] weight once per chunk. Returns
    (view batch, chunk_labels [T' / chunk]). The loss is a masked sum over
    triples, so the view trains exactly as the batch does."""
    align = max(align, chunk)
    if align % chunk:
        raise ValueError(f"align {align} is not a multiple of chunk {chunk}")
    dev = batch.labels.device
    labels = batch.labels.cpu().numpy()
    arrays = {name: getattr(batch, name).cpu().numpy()
              for name in ("head_idx", "tail_idx", "pos_neg", "mask")}
    order = np.argsort(labels, kind="stable")
    uniq, counts = np.unique(labels[order], return_counts=True)
    padded = ((counts + chunk - 1) // chunk) * chunk
    total = int(padded.sum())
    grand = ((total + align - 1) // align) * align
    run_starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    in_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = (np.arange(len(order)) - np.repeat(in_starts, counts)
           + np.repeat(run_starts, counts))
    lab_arena = np.zeros((grand,), labels.dtype)
    lab_arena[:total] = np.repeat(uniq, padded)
    out = {}
    for name, a in arrays.items():
        arena = np.zeros((grand,) + a.shape[1:], a.dtype)
        arena[pos] = a[order]
        out[name] = torch.from_numpy(arena).to(dev)
    view = dataclasses.replace(batch, labels=torch.from_numpy(lab_arena).to(
        dev), **out)
    return view, torch.from_numpy(lab_arena[::chunk].copy()).to(dev)


class FinetuneTrainer:
    """Stage-3 trainer of `model` (a MadrigalMultilabel on the batch's
    device, put in train mode) over one collated batch and its KG batch.
    Optimizer state starts fresh."""

    def __init__(self, cfg: TrainConfig, batch: DDIBatch, kg: HeteroKGBatch,
                 model: MadrigalMultilabel):
        if cfg.use_single_drug:
            raise NotImplementedError(
                "use_single_drug: the single-drug head is not ported yet "
                "(ROADMAP)")
        if cfg.loss_fn_name != "bce" or cfg.task != "multilabel":
            raise NotImplementedError(
                f"loss {cfg.loss_fn_name!r} / task {cfg.task!r}: only the "
                "multilabel bce loss is ported (ROADMAP)")
        self.cfg = cfg
        self.batch = batch
        self.kg = kg
        self.device = batch.labels.device
        self.model = model.train()
        self.optimizer, self.scheduler = create_optimizer(
            model, cfg.optim, warmup_epochs=cfg.warmup_epochs,
            total_epochs=cfg.num_epochs, frozen_encoder=cfg.frozen)
        self.params = [p for g in self.optimizer.param_groups
                       for p in g["params"]]
        self.epoch = 0

        self.masker = FinetuneMasker(
            cfg.finetune_mode, batch.head.masks.cpu().numpy(),
            list(NON_TX_MODALITIES),
            train_with_str_str=cfg.train_with_str_str, seed=cfg.seed)

        # label-chunked training view (self.batch keeps the collator's
        # triple order)
        self.label_chunk = int(cfg.label_chunk_triples or 0)
        if self.label_chunk:
            self.train_batch, self.chunk_labels = label_chunk_view(
                batch, self.label_chunk)
        else:
            self.train_batch, self.chunk_labels = batch, None

        # loss weights over the training view's triples
        tb = self.train_batch
        head_g = tb.head.drugs.long()[tb.head_idx.long()]
        tail_g = tb.tail.drugs.long()[tb.tail_idx.long()]
        self.w_directed = tb.mask & (head_g < tail_g)
        self.w_all = (self.w_directed if self.masker.edges_directed_only()
                      else tb.mask)

    def _forward_loss(self, masks_head, masks_tail, weights, table):
        tb = self.train_batch
        head = dataclasses.replace(tb.head, masks=masks_head)
        tail = dataclasses.replace(tb.tail, masks=masks_tail)
        out = self.model.score_triples(
            head, tail, None, tb.head_idx, tb.tail_idx, tb.labels,
            kg_drug_table=table, chunk_labels=self.chunk_labels,
            label_chunk=self.label_chunk)
        return masked_bce(out, tb.pos_neg, weights, self.cfg.loss_readout)

    def train_epoch(self) -> Dict[str, float]:
        """One step over the full batch; returns the forwards' losses and
        their sum under 'total'."""
        mh, mt = self.masker.sample_epoch()
        mh = torch.from_numpy(np.ascontiguousarray(mh)).to(self.device)
        mt = torch.from_numpy(np.ascontiguousarray(mt)).to(self.device)
        if self.masker.uses_three_way_loss:
            plan = []
            if self.cfg.train_with_str_str:
                plan.append(("str_str", mh, mh, self.w_directed))
            plan += [("X_X", mt, mt, self.w_directed),
                     ("str_X", mh, mt, self.w_all)]
        else:
            plan = [("total", mh, mt, self.w_all)]

        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        table = self.model.encoder.kg_drug_table(self.kg)
        shared = table.detach().requires_grad_()
        losses = {}
        for name, h, t, w in plan:
            loss = self._forward_loss(h, t, w, shared)
            loss.backward()
            losses[name] = float(loss.detach())
        if shared.grad is not None:
            table.backward(shared.grad)
        for p in self.params:
            # a parameter the loss does not reach gets a zero gradient, so
            # AdamW still decays it and advances its moments, as optax does
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.scheduler.step()
        self.epoch += 1
        if len(plan) > 1:
            losses["total"] = sum(losses.values())
        return losses

    def training_state(self) -> dict:
        """Optimizer and schedule state, for a checkpoint."""
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_training_state(self, state: dict, epoch: int) -> None:
        """Resume after `epoch` steps: optimizer and schedule state, and
        the mask sampler moved on by as many epochs, so the run continues
        as one that never stopped."""
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        for _ in range(epoch - self.epoch):
            self.masker.sample_epoch()
        self.epoch = epoch
