"""Sharded trainers (port of `madrigal_tpu/parallel/train_step.py`).

`shard_finetune_trainer` re-places a FinetuneTrainer on a ('dp', 'label')
mesh, in place: the DDI triples split over 'dp' (each rank keeps its
contiguous part of the training view), the decoder weight [L, D, D] over
'label' (each rank keeps its contiguous outcomes, and of its triples
those whose label it holds), and the encoder and the KG are replicated,
or the KG's edges split over `kg_shard_axis` (graph parallel,
`kg_shard.py`). Every rank runs the replicated encoder on the whole drug
batches, so BatchNorm statistics and dropout draws are the single
device's. After the backward the replicated parameters' gradients are
summed over every rank and each decoder shard's over 'dp' (the rule in
`collectives.py`), the first rank's BatchNorm statistics are copied to
the others (the card's atomic adds make each rank's differ in their
last bits), and the optimizer steps each rank's parameters as one
device would step the whole (LARS with the whole decoder's norms).

`shard_cl_pretrainer` splits stage 2's batch over 'dp' on both paths:
every rank draws the whole batch from the shared seed and keeps its
rows; the BatchNorms that see a rank's rows take the statistics of the
whole batch; InfoNCE scores the gathered rows (`collectives.gather_rows`).
With dropout in the model a rank's draws are its own, so the sharded
stage-2 step equals the single device's in distribution, and exactly
when the dropout rates are 0.

Both trainers run their collectives on every step, so every rank must
call `train_epoch` / `train_step` together.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from .collectives import all_reduce_grads, all_gather_tensor
from .collectives import broadcast_tensors
from .mesh import axis_group, axis_rank, axis_size, make_mesh, mesh_shape


def make_train_mesh(n_devices: Optional[int] = None,
                    label_dim: Optional[int] = None):
    """A ('dp', 'label') mesh over every rank (n_devices, when given, must
    be the world size): label_dim 2 when the count is even and above 1,
    else 1."""
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_train_mesh spans every rank: asked for "
                         f"{n_devices}, the world holds {n}")
    if label_dim is None:
        label_dim = 2 if n % 2 == 0 and n > 1 else 1
    return make_mesh(("dp", "label"), (n // label_dim, label_dim))


def _replicate(model: nn.Module) -> None:
    """Every rank starts from the first rank's parameters and buffers."""
    broadcast_tensors(list(model.parameters()) + list(model.buffers()))


def _set_bn_group(module: nn.Module, group) -> None:
    from ..models.norm import MaskedBatchNorm

    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.group = group


def _kg_share(trainer, mesh, kg_shard_axis, encoder_attr):
    from .kg_shard import device_put_kg_sharded, make_sharded_kg_table_fn

    trainer.kg = device_put_kg_sharded(trainer.kg, mesh, kg_shard_axis)
    trainer._kg_table_fn = make_sharded_kg_table_fn(
        trainer.model, mesh, axis=kg_shard_axis, encoder_attr=encoder_attr)


def shard_finetune_trainer(trainer, mesh, kg_shard_axis=None):
    """Re-place an existing FinetuneTrainer onto `mesh` (in place; every
    rank calls it on a trainer built from the same batch and seed).

    Requirements: the padded triple count must divide mesh 'dp' and the
    label count must divide mesh 'label' (use the collator's pair_budget
    to round up).

    kg_shard_axis: optional mesh axis name; when set, the full-KG HGT
    pass of every step runs graph-parallel over that axis (edges split,
    segment reductions merged), with exact gradients."""
    shape = mesh_shape(mesh)
    T = int(trainer.batch.labels.shape[0])
    if T % shape["dp"] != 0:
        raise ValueError(
            f"triple count {T} must divide dp={shape['dp']}; "
            "collate with a pair_budget rounded to a dp multiple"
        )
    lc = trainer.label_chunk
    if lc:
        Tt = int(trainer.train_batch.labels.shape[0])
        if (Tt // lc) % shape["dp"] != 0:
            raise ValueError(
                f"label-chunked triple count {Tt} / chunk {lc} must "
                f"divide dp={shape['dp']} (chunk-aligned shards)"
            )
    L = trainer.cfg.model.prediction_dim
    if L % shape["label"] != 0:
        raise ValueError(
            f"label count {L} must divide label={shape['label']}"
        )
    model = trainer.model
    _replicate(model)
    dp, d = shape["dp"], axis_rank(mesh, "dp")
    nl, li = shape["label"], axis_rank(mesh, "label")
    l0, l1 = li * (L // nl), (li + 1) * (L // nl)

    # the decoder's label shard, in the model and in the optimizer
    old = model.decoder.weight
    new = nn.Parameter(old.detach()[l0:l1].clone())
    model.decoder.weight = new
    opt = trainer.optimizer
    for g in opt.param_groups:
        g["params"] = [new if p is old else p for p in g["params"]]
    st = opt.state.pop(old, None)
    if st:
        opt.state[new] = {k: (v[l0:l1].clone() if torch.is_tensor(v)
                              and v.shape == old.shape else v)
                          for k, v in st.items()}
    trainer.params = [new if p is old else p for p in trainer.params]
    label_group = axis_group("label", mesh)
    if nl > 1 and hasattr(opt, "shard_groups"):
        opt.shard_groups[new] = label_group

    # this rank's triples: its contiguous dp part of the training view
    # (whole label chunks), of them those whose label it holds
    tb = trainer.train_batch
    if lc:
        n_chunks = tb.labels.shape[0] // lc
        per = n_chunks // dp
        cl = trainer.chunk_labels[d * per:(d + 1) * per]
        keep_chunks = (cl >= l0) & (cl < l1)
        sel = (torch.arange(d * per, (d + 1) * per, device=cl.device)[
            keep_chunks][:, None] * lc
            + torch.arange(lc, device=cl.device)).reshape(-1)
        trainer.chunk_labels = cl[keep_chunks] - l0
    else:
        per = tb.labels.shape[0] // dp
        part = torch.arange(d * per, (d + 1) * per, device=tb.labels.device)
        lab = tb.labels[part]
        sel = part[(lab >= l0) & (lab < l1)]
    trainer.train_batch = dataclasses.replace(
        tb, head_idx=tb.head_idx[sel], tail_idx=tb.tail_idx[sel],
        labels=tb.labels[sel] - l0, pos_neg=tb.pos_neg[sel],
        mask=tb.mask[sel])
    trainer.w_directed = trainer.w_directed[sel]
    trainer.w_all = trainer.w_all[sel]

    if kg_shard_axis is not None:
        _kg_share(trainer, mesh, kg_shard_axis, "encoder")
    world = dist.group.WORLD
    replicated = [p for p in trainer.params if p is not new]
    dp_group = axis_group("dp", mesh)

    buffers = [b for b in model.buffers() if b.is_floating_point()]

    def reduce_grads():
        all_reduce_grads(replicated, world)
        all_reduce_grads([new], dp_group)
        # each rank's replicated forward updated its BatchNorm statistics;
        # atomic adds on the card make them differ in their last bits
        broadcast_tensors(buffers, world)

    trainer.loss_group = world
    trainer._reduce_grads = reduce_grads
    trainer.label_range = (l0, l1)
    trainer.mesh = mesh
    return trainer


def gather_decoder_weight(trainer) -> torch.Tensor:
    """The whole [L, D, D] decoder weight of a sharded FinetuneTrainer,
    on every rank (for evaluation, export or a checkpoint)."""
    w = trainer.model.decoder.weight.detach()
    return all_gather_tensor(w, axis_group("label", trainer.mesh))


def shard_cl_pretrainer(trainer, mesh, kg_shard_axis=None):
    """Data-parallel stage-2 pretraining (in place; every rank calls it on
    a trainer built from the same data and seed): parameters replicated,
    each step's drug batch split over 'dp' on the device-table and the
    host-collate path alike; the InfoNCE similarity spans the whole batch.

    Requires the batch size divisible by mesh 'dp'.

    kg_shard_axis: optional mesh axis; when set, the per-step full-KG HGT
    pass runs graph-parallel over it."""
    dp = axis_size(mesh, "dp")
    if trainer.batch_size % dp != 0:
        raise ValueError(
            f"pretrain batch {trainer.batch_size} must divide "
            f"dp={dp}"
        )
    model = trainer.model
    _replicate(model)
    group = axis_group("dp", mesh)
    d, per = axis_rank(mesh, "dp"), trainer.batch_size // dp
    trainer.row_slice = slice(d * per, (d + 1) * per)
    model.gather_group = group
    if trainer.full_batch is not None:
        # the modality encoders run on the whole (replicated) drug table;
        # what follows the row gather sees this rank's rows only
        enc = model.base_encoder
        for name in ("uni_projector", "uni_fuser", "transformer",
                     "pos_encoder"):
            if hasattr(enc, name):
                _set_bn_group(getattr(enc, name), group)
        for name in ("predictor", "predictor_1", "predictor_2"):
            if hasattr(model, name):
                _set_bn_group(getattr(model, name), group)
    else:
        _set_bn_group(model, group)
    if kg_shard_axis is not None:
        _kg_share(trainer, mesh, kg_shard_axis, "base_encoder")

    buffers = [b for b in model.buffers() if b.is_floating_point()]

    def reduce_grads():
        all_reduce_grads(trainer.params, group)
        broadcast_tensors(buffers, group)  # as in shard_finetune_trainer

    trainer._reduce_grads = reduce_grads
    trainer.mesh = mesh
    return trainer
