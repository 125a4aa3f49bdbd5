"""Every input of a run, made from its seed: the dataset (the frozen
generator in `reference/data/synthetic.py`), the training rows, the
initial weights, and the rank cell's embeddings and decoder weights.

Both sides of a comparison get these same inputs: the port and the plain
reference each collate, lay out and mask them on their own.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.data.synthetic import make_reference_scale_dataset


def seed32(seed: int) -> int:
    """The seed as numpy's RandomState takes it (below 2**32)."""
    return int(seed) % (2 ** 32)


def dataset(data: dict, mix: dict, seed: int):
    """The synthetic TWOSIDES-shaped dataset of a configuration's `data`
    (the generator's keyword arguments: num_drugs, num_labels, num_rows,
    kg_scale, kg_feat_dim, kg_degrees, kg_zipf_a), with the mix's own
    `data` keys, where it has them, in place of the configuration's."""
    return make_reference_scale_dataset(seed=seed32(seed),
                                        **{**data, **mix.get("data", {})})


def train_rows(ds, share: float, seed: int):
    """The training rows: a seeded permutation of the DDI table, its first
    `share` (the training CLI's 80/10/10 split keeps 0.8)."""
    df = ds.edge_df
    perm = np.random.RandomState(seed32(seed)).permutation(len(df))
    return df.take(np.sort(perm[:int(round(share * len(df)))]))


def _scale(name: str, shape: tuple):
    """(std of the normal draw, constant) for one parameter: biases 0,
    other vectors 1 (norm scales, gates), GIN's eps left as built,
    matrices and tables normal with std 1/sqrt(their last dim)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "eps":
        return None, None
    if leaf == "bias" or leaf.endswith("_bias"):
        return 0.0, 0.0
    if len(shape) <= 1:
        return 0.0, 1.0
    return 1.0 / math.sqrt(shape[-1]), 0.0


@torch.no_grad()
def load_weights(model: torch.nn.Module, seed: int,
                 skip=lambda name: False) -> None:
    """Fill every parameter of `model` (except `skip`'s) from one normal
    draw of a generator on the model's device seeded with `seed`, sliced
    by parameter name in sorted order, so any two models with the same
    parameter names and shapes get the same weights."""
    params = dict(model.named_parameters())
    names = sorted(n for n in params if not skip(n))
    dev = params[names[0]].device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    total = sum(params[n].numel() for n in names)
    flat = torch.randn(total, generator=gen, device=dev,
                       dtype=torch.float32)
    at = 0
    for n in names:
        p = params[n]
        std, const = _scale(n, tuple(p.shape))
        piece = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
        if std is None:
            continue
        p.copy_(piece * std + const if std else
                torch.full_like(p, const))


def rank_inputs(num_drugs: int, num_labels: int, dim: int, seed: int,
                device) -> tuple:
    """(z [N, D], w_sym [L, D, D]) float32 on `device`: embeddings with
    unit-normal entries and a decoder weight W with entries of std
    1/sqrt(D), symmetrized as the decoder does, triu(W) + triu(W, 1)^T."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(num_drugs, dim, generator=gen, device=device)
    w = torch.randn(num_labels, dim, dim, generator=gen, device=device)
    w.mul_(1.0 / math.sqrt(dim))
    return z, torch.triu(w) + torch.triu(w, 1).transpose(1, 2)
