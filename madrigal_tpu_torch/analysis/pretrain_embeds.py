"""Per-modality embedding drift across pretraining, the fig1 workflow
(port of `madrigal_tpu/analysis/pretrain_embeds.py`; reference
notebooks/fig1/fig1_pretrained_embeds.ipynb cells 2/7-9): sample a
handful of full-modality drugs, embed each through every single-modality
path before and after contrastive pretraining, project the stacked
embeddings to 2-D and measure how close each drug's modalities come.

Where the JAX functions take an apply function and two flax trees, these
take a `MadrigalEncoder` and two of its state_dicts (e.g. its initial
weights and the `base_encoder.` entries of a `cli.pretrain` checkpoint);
the embeddings come from `eval/evaluate_pt.encode_single_modality` on
the encoder's device, the rest runs with numpy on the host. The
projection is `eval/cl_metrics.embedding_plot_coords` (UMAP when
installed, else PCA).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..constants import NON_TX_MODALITIES
from ..eval.ablation import full_modality_drugs
from ..eval.cl_metrics import embedding_plot_coords
from ..eval.evaluate_pt import (
    DEFAULT_EVAL_MODALITY_INDICES,
    encode_single_modality,
    kg_table,
)


def sample_full_modality_drugs(
    masks: np.ndarray, n_drugs: int = 10, seed: int = 1,
) -> np.ndarray:
    """Sorted sample of drugs that have every modality (fig1 cell 7:
    np.random.choice over full_modality_drugs, size 10, seed 1)."""
    pool = full_modality_drugs(masks)
    if len(pool) == 0:
        raise ValueError("no full-modality drugs to sample")
    rng = np.random.RandomState(seed)
    take = min(n_drugs, len(pool))
    return np.sort(rng.choice(pool, size=take, replace=False))


def modality_embedding_table(
    encoder,
    state_dict: Mapping[str, torch.Tensor],
    collator,
    kg,
    drug_ids: np.ndarray,
    modality_indices: Sequence[int] = DEFAULT_EVAL_MODALITY_INDICES,
) -> Dict[str, np.ndarray]:
    """Stacked single-modality embeddings for a drug set under the weights
    `state_dict` (loaded into `encoder`, which keeps them): each drug is
    encoded once per modality it has, masked to only that modality (fig1
    cell 7's per-modality forward). Returns {'embeds': [R, D],
    'modality': [R] int (column index), 'drug': [R] int}."""
    encoder.load_state_dict(state_dict, strict=True)
    table = kg_table(encoder, kg)
    embeds, mods, drugs = [], [], []
    for mi in modality_indices:
        z, valid = encode_single_modality(
            encoder, collator, kg, np.asarray(drug_ids, np.int64), mi,
            kg_drug_table=table)
        if len(valid) == 0:
            continue
        embeds.append(np.asarray(z))
        mods.append(np.full(len(valid), mi, np.int64))
        drugs.append(np.asarray(valid, np.int64))
    if not embeds:
        raise ValueError("no (drug, modality) rows to embed")
    return {"embeds": np.concatenate(embeds),
            "modality": np.concatenate(mods),
            "drug": np.concatenate(drugs)}


def pretrain_embedding_shift(
    encoder,
    state_before: Mapping[str, torch.Tensor],
    state_after: Mapping[str, torch.Tensor],
    collator,
    kg,
    n_drugs: int = 10,
    seed: int = 1,
    modality_indices: Sequence[int] = DEFAULT_EVAL_MODALITY_INDICES,
    method: str = "auto",
    drug_ids: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """The full fig1 comparison: sample full-modality drugs, build the
    per-modality embedding table under both state_dicts, project each
    to 2-D. Returns {'drugs', 'modality', 'drug', 'coords_before',
    'coords_after', 'projection', 'alignment'} where alignment is the
    mean per-drug cross-modality cosine similarity before/after — the
    scalar the scatter visualizes (it should rise with pretraining).
    `encoder` is left holding `state_after`."""
    if drug_ids is None:
        drug_ids = sample_full_modality_drugs(
            np.asarray(collator.ds.masks), n_drugs, seed)
    before = modality_embedding_table(
        encoder, state_before, collator, kg, drug_ids, modality_indices)
    after = modality_embedding_table(
        encoder, state_after, collator, kg, drug_ids, modality_indices)
    coords_b, proj = embedding_plot_coords(before["embeds"], method)
    coords_a, _ = embedding_plot_coords(after["embeds"], method)
    return {
        "drugs": drug_ids,
        "modality": after["modality"],
        "drug": after["drug"],
        "coords_before": coords_b,
        "coords_after": coords_a,
        "projection": proj,
        "alignment": {
            "before": per_drug_modality_alignment(before),
            "after": per_drug_modality_alignment(after),
        },
    }


def per_drug_modality_alignment(table: Dict[str, np.ndarray]) -> float:
    """Mean cosine similarity between same-drug different-modality
    embedding pairs — the quantity fig1's clusters display. NaN when no
    drug has two modalities in the table."""
    z = np.asarray(table["embeds"], np.float64)
    z = z / np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1e-12)
    drug = np.asarray(table["drug"])
    sims = []
    for d in np.unique(drug):
        rows = z[drug == d]
        if len(rows) < 2:
            continue
        g = rows @ rows.T
        iu = np.triu_indices(len(rows), k=1)
        sims.append(g[iu])
    return float(np.concatenate(sims).mean()) if sims else float("nan")


MODALITY_COLUMN_NAMES = tuple(NON_TX_MODALITIES)
