"""Contrastive-pretraining evaluation (port of
`madrigal_tpu/eval/evaluate_pt.py`; reference evaluate_pt /
evaluate_pretrain_subsets / save_embeds, madrigal/evaluate/
evaluate.py:254-504, eval_utils.py:308-383): encode drugs under
single-modality masks, compute per-modality-pair retrieval top-k,
FOSCTTM, alignment and uniformity, and export per-modality embedding
tables.

Where the JAX functions take an apply function and its variables, these
take the encoder module (a MadrigalEncoder; it is put in eval mode). The
KG drug table is computed once per call and shared by every batch; the
JAX package recomputes it for each batch, to the same values. File
names and metric keys are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import json
import os
from itertools import combinations
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..constants import CELL_LINES, NON_TX_MODALITIES, NUM_MODALITIES
from .cl_metrics import (
    alignment_loss,
    foscttm,
    retrieval_topk_accuracy,
    uniform_loss,
)
from .geomca import geomca

# modalities the reference saves/evaluates (eval_utils.py:322-329)
DEFAULT_EVAL_MODALITY_INDICES = tuple(
    list(range(len(NON_TX_MODALITIES)))
    + [len(NON_TX_MODALITIES) + i for i, c in enumerate(CELL_LINES)
       if c in ("mcf7", "pc3", "vcap")]
)


@torch.no_grad()
def kg_table(encoder, kg) -> torch.Tensor:
    """The encoder's KG drug table in eval mode."""
    return encoder.eval().kg_drug_table(kg)


@torch.no_grad()
def encode_single_modality(
    encoder,
    collator,
    kg,
    drug_ids: np.ndarray,
    modality_index: int,
    raw_encoder_output: bool = True,
    batch_size: int = 1024,
    kg_drug_table: Optional[torch.Tensor] = None,
):
    """Embed the drugs that HAVE `modality_index`, masked to only it
    (save_embeds semantics, eval_utils.py:308-383). Returns ([n_valid, D]
    embeddings, the valid drug ids)."""
    encoder.eval()
    if kg_drug_table is None:
        kg_drug_table = kg_table(encoder, kg)
    masks = np.asarray(collator.ds.masks)
    drug_ids = np.asarray(drug_ids)
    valid = drug_ids[~masks[drug_ids, modality_index]]
    outs = []
    for s in range(0, len(valid), batch_size):
        ids = valid[s:s + batch_size]
        batch = collator.drug_batch(ids)
        m = np.ones((len(ids), NUM_MODALITIES), dtype=bool)
        m[:, modality_index] = False
        batch = dataclasses.replace(
            batch, masks=torch.from_numpy(m).to(batch.masks.device))
        z = encoder.encode(batch, kg_drug_table=kg_drug_table,
                           raw_encoder_output=raw_encoder_output)
        outs.append(z.cpu().numpy())
    return (np.concatenate(outs) if outs else
            np.zeros((0, 1), np.float32)), valid


def evaluate_pt(
    encoder,
    collator,
    kg,
    drug_ids: np.ndarray,
    modality_indices: Sequence[int] = DEFAULT_EVAL_MODALITY_INDICES,
    topk=(1, 5, 20),
    raw_encoder_output: bool = True,
) -> Dict[str, float]:
    """Cross-modality retrieval metrics over all modality pairs with
    shared drugs (evaluate.py:254-400 evaluate_pt core)."""
    table = kg_table(encoder, kg)
    embeds: Dict[int, np.ndarray] = {}
    ids: Dict[int, np.ndarray] = {}
    for mi in modality_indices:
        z, valid = encode_single_modality(
            encoder, collator, kg, drug_ids, mi, raw_encoder_output,
            kg_drug_table=table)
        if len(valid) > 0:
            embeds[mi] = z
            ids[mi] = valid

    metrics: Dict[str, float] = {}
    for a in embeds:
        metrics[f"uniformity_{a}"] = uniform_loss(embeds[a]) \
            if len(embeds[a]) > 2 else float("nan")
        for b in embeds:
            if b <= a:
                continue
            shared, ia, ib = np.intersect1d(
                ids[a], ids[b], return_indices=True
            )
            if len(shared) < 3:
                continue
            za, zb = embeds[a][ia], embeds[b][ib]
            accs = retrieval_topk_accuracy(za, zb, topk)
            for k, acc in zip(topk, accs):
                metrics[f"top{k}_{a}_{b}"] = acc
            mu, _ = foscttm(zb, za)
            metrics[f"foscttm_{a}_{b}"] = mu
            metrics[f"alignment_{a}_{b}"] = alignment_loss(za, zb)
    return metrics


def evaluate_final_embeds(
    outputs: Dict[str, Dict[str, dict]],
    save_dir: Optional[str] = None,
    run_geomca: bool = True,
    geomca_kwargs: Optional[dict] = None,
    logger=None,
) -> Dict[str, Dict[str, float]]:
    """End-of-pretraining alignment table over saved per-modality embeds
    (reference evaluate_final_embeds / get_alignment_metrics,
    evaluate.py:456-504): for every split and every modality pair in the
    `save_embeds` output, intersect the drug sets, align the embeddings,
    and compute alignment, per-side uniformity and FOSCTTM, plus the
    GeomCA precision, recall, network consistency and network quality.
    Returns {"<split> <a> v <b>": {metric: v}} and writes
    `final_embeds_metrics.json` when `save_dir` is given."""
    table: Dict[str, Dict[str, float]] = {}
    for split, per_mod in outputs.items():
        for a, b in combinations(sorted(per_mod, key=int), 2):
            da, db = per_mod[a], per_mod[b]
            shared, ia, ib = np.intersect1d(
                da["drugs"], db["drugs"], return_indices=True
            )
            if len(shared) < 3:
                continue
            za = np.asarray(da["embeds"])[ia]
            zb = np.asarray(db["embeds"])[ib]
            row = {
                "alignment": alignment_loss(za, zb),
                "uniformity_a": uniform_loss(za),
                "uniformity_b": uniform_loss(zb),
                "foscttm": foscttm(zb, za)[0],
                "sample_size": float(len(shared)),
            }
            if run_geomca:
                # reference GeomCA params: Rdist_percentile=5, gamma=1,
                # comp thresholds 0.0 (evaluate.py:478-495)
                gk = dict(percentile=5.0, gamma=1.0,
                          comp_consistency_threshold=0.0,
                          comp_quality_threshold=0.0)
                gk.update(geomca_kwargs or {})
                res = geomca(za, zb, **gk)
                row.update(
                    geomca_precision=res.precision,
                    geomca_recall=res.recall,
                    geomca_network_consistency=res.network_consistency,
                    geomca_network_quality=res.network_quality,
                )
            name = f"{split} {a} v {b}"
            table[name] = row
            if logger is not None:
                logger.info(
                    f"final embeds {name}: "
                    + ", ".join(f"{k}={v:.4f}" for k, v in row.items())
                )
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "final_embeds_metrics.json"),
                  "w") as f:
            json.dump(table, f, indent=1)
    return table


def save_embeds(
    encoder, collator, kg, train_drugs, val_drugs,
    save_dir: Optional[str] = None,
    modality_indices: Sequence[int] = DEFAULT_EVAL_MODALITY_INDICES,
    raw_encoder_output: bool = True,
):
    """Per-modality embedding export for train/val drug sets
    (eval_utils.py:308-383). Returns {split: {mod_idx: {embeds, drugs}}}
    and writes `<split>_embeds_<mod_idx>.npz` files when save_dir is
    given."""
    table = kg_table(encoder, kg)
    out = {}
    for split, drugs in (("train", train_drugs), ("val", val_drugs)):
        out[split] = {}
        for mi in modality_indices:
            z, valid = encode_single_modality(
                encoder, collator, kg, np.asarray(drugs), mi,
                raw_encoder_output, kg_drug_table=table)
            if not len(valid):
                continue
            out[split][str(mi)] = {"embeds": z, "drugs": valid}
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                np.savez(
                    os.path.join(save_dir, f"{split}_embeds_{mi}.npz"),
                    embeds=z, drugs=valid,
                    masks=np.asarray(collator.ds.masks)[valid],
                )
    return out
