"""Prediction / serving API (port of `madrigal_tpu/eval/predict.py`;
reference madrigal/evaluate/predict.py):

  * `model_from_checkpoint`: the model rebuilt from the embedded config;
  * `embed_all_drugs`: the [N, D] embedding table, one KG pass and drug
    batches of 1024;
  * `score_all_pairs`: the label-chunked [L, N_head, N_tail] score export
    into a host array or np.memmap, through kernel K1 (`ops/bilinear.py`)
    -- the CUDA kernel for a model on the card, its plain version on the
    CPU;
  * `score_triples_for_pairs`: (outcome, drugA, drugB) lookups.

Functions take an explicit `device` where they create tensors; `None`
means CUDA and raises without a card. Each serving phase logs its wall
time at INFO, with `phase` and `seconds` attached to the log record.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..data.collate import DDICollator
from ..data.kg import HeteroKGBatch
from ..device import resolve_device
from ..models.encoder import (
    MadrigalMultilabel,
    build_model,
    kg_schema_from_state_dict,
)
from ..ops.bilinear import bilinear_scores
from ..train.checkpoint import load_checkpoint

logger = logging.getLogger(__name__)


def log_phase(phase: str, t0: float, device: torch.device) -> float:
    """Log the wall time since `t0` of a phase that ran on `device` (once
    the device has finished it) and return the current time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    logger.info(f"{phase}: {t - t0:.3f} s",
                extra={"phase": phase, "seconds": t - t0})
    return t


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def model_from_checkpoint(path: str, device=None):
    """(model in eval mode on `device`, cfg) from a port checkpoint."""
    dev = resolve_device(device)
    sd, cfg = load_checkpoint(path)
    if isinstance(cfg, TrainConfig):
        model_cfg = cfg.model
    elif isinstance(cfg, ModelConfig):
        model_cfg = cfg
    else:
        raise TypeError(type(cfg))
    node_dims, edge_types = kg_schema_from_state_dict(sd)
    model = build_model(model_cfg, node_dims, edge_types, device=dev)
    model.load_state_dict(sd, strict=True)
    return model, cfg


@torch.no_grad()
def embed_all_drugs(
    model: MadrigalMultilabel,
    collator: DDICollator,
    kg: HeteroKGBatch,
    drug_ids: Optional[np.ndarray] = None,
    eval_masks: Optional[np.ndarray] = None,
    batch_size: int = 1024,
) -> np.ndarray:
    """[N, D] fused drug embeddings under full (or the given) modality
    masks. The KG message pass runs once; drug batches stream through the
    encoder."""
    ds = collator.ds
    drug_ids = (np.arange(ds.num_drugs) if drug_ids is None
                else np.asarray(drug_ids))
    dev = _model_device(model)
    t0 = time.perf_counter()
    table = model.encoder.kg_drug_table(kg)
    t0 = log_phase("kg_pass", t0, dev)
    outs = []
    for s in range(0, len(drug_ids), batch_size):
        ids = drug_ids[s:s + batch_size]
        batch = collator.drug_batch(ids)
        if eval_masks is not None:
            batch = dataclasses.replace(batch, masks=torch.as_tensor(
                eval_masks[ids], device=batch.masks.device))
        z = model.encoder.encode(batch, kg_drug_table=table)
        outs.append(z.cpu().numpy())
    log_phase("drug_encode", t0, dev)
    return np.concatenate(outs, axis=0)


@torch.no_grad()
def decoder_weight(model: MadrigalMultilabel) -> torch.Tensor:
    """Symmetrized decoder weight [L, D, D] on the model's device."""
    return model.decoder.w_sym()


@torch.no_grad()
def score_all_pairs(
    model: MadrigalMultilabel,
    z_head,
    z_tail=None,
    label_chunk: int = 32,
    out: Optional[np.ndarray] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> np.ndarray:
    """[L, N_head, N_tail] raw f32 scores, label-chunked into `out` (pass
    an np.memmap for the reference artifact export).

    On a model on the card every chunk launches kernel K1, in either
    compute dtype; on the CPU it runs K1's plain version. compute_dtype
    float32 keeps per-triple parity; bfloat16 is the throughput export."""
    dev = _model_device(model)
    t0 = time.perf_counter()
    w_sym = decoder_weight(model)
    L = w_sym.shape[0]
    zh = torch.as_tensor(np.asarray(z_head, np.float32)).to(dev)
    zt = zh if z_tail is None else torch.as_tensor(
        np.asarray(z_tail, np.float32)).to(dev)
    if out is None:
        out = np.empty((L, zh.shape[0], zt.shape[0]), np.float32)
    for s in range(0, L, label_chunk):
        e = min(s + label_chunk, L)
        blk = bilinear_scores(zh, zt, w_sym[s:e].contiguous(),
                              out_dtype=torch.float32,
                              compute_dtype=compute_dtype)
        out[s:e] = blk.cpu().numpy()
    log_phase("scoring", t0, dev)
    return out


@torch.no_grad()
def score_triples_for_pairs(
    model: MadrigalMultilabel, z,
    triples: Sequence[Tuple[int, int, int]],
) -> np.ndarray:
    """Scores for explicit (label, drugA, drugB) triples."""
    L = model.decoder.weight.shape[0]
    n = z.shape[0]
    for t in triples:
        if not (0 <= t[0] < L):
            raise ValueError(f"outcome {t[0]} out of range [0, {L})")
        if not (0 <= t[1] < n and 0 <= t[2] < n):
            raise ValueError(f"drug index out of range [0, {n}): {t}")
    dev = _model_device(model)
    zt = torch.as_tensor(np.asarray(z, np.float32)).to(dev)
    idx = torch.as_tensor(np.asarray(triples, np.int64).reshape(-1, 3),
                          device=dev)
    out = model.decoder.triples(zt[idx[:, 1]], zt[idx[:, 2]], idx[:, 0])
    return out.cpu().numpy()
