"""Symmetric bilinear DDI decoder (port of `madrigal_tpu/models/decoder.py`;
reference models.py:522-547).

score[l, i, j] = z_head[i] @ W_sym[l] @ z_tail[j], W_sym = triu(W) +
triu(W, 1)^T per outcome (no bias).

  * `triples`: only the (label, head, tail) entries asked for, one
    gathered [D, D] weight per triple, or with the label-chunked layout
    of training (`train/finetune.label_chunk_view`) one per chunk of
    `label_chunk` triples that share a label (the only form training
    runs; the port's all-pairs and indexed forms are not kept).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn



def symmetrize(w: torch.Tensor) -> torch.Tensor:
    """triu(W) + triu(W, 1)^T over the last two dims."""
    return torch.triu(w) + torch.triu(w, 1).transpose(-1, -2)


class BilinearDDIScorer(nn.Module):
    """Per-outcome symmetric bilinear scorer, weight [L, D1, D2]."""

    # triples scored per step: bounds the gathered [C, D, D] weights
    TRIPLE_CHUNK = 8192
    # label-chunked layout: [D, D] weight slices gathered per step (64 MB
    # at D = 128 in f32), whatever label_chunk is
    SCAN_WEIGHT_ROWS = 1024

    def __init__(self, num_labels: int, input_dim1: int, input_dim2: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(num_labels, input_dim1, input_dim2))

    def w_sym(self, label_range: Optional[Tuple[int, int]] = None):
        w = self.weight
        if label_range is not None:
            w = w[label_range[0]:label_range[1]]
        return symmetrize(w)

    def triples(self, z_head: torch.Tensor, z_tail: torch.Tensor,
                labels: torch.Tensor,
                chunk_labels: Optional[torch.Tensor] = None,
                label_chunk: int = 0) -> torch.Tensor:
        """Scores for aligned (head, tail, label) triples: z_head/z_tail
        [T, D], labels [T] -> [T].

        With chunk_labels [T / label_chunk], triple i's label is
        chunk_labels[i // label_chunk], and each [D, D] slice is gathered
        once per chunk (decoder.py:102-140 of the JAX package; a loop over
        bounded steps takes the place of its scan)."""
        w_sym = self.w_sym()
        if chunk_labels is not None:
            c = label_chunk
            T, D = z_head.shape
            if c <= 0 or T % c:
                raise ValueError(f"{T} triples are not whole chunks of {c}")
            zh3 = z_head.reshape(-1, c, D)
            zt3 = z_tail.reshape(-1, c, D)
            step = self.SCAN_WEIGHT_ROWS
            out = [torch.einsum("tcd,tde,tce->tc", zh3[s:s + step],
                                w_sym[chunk_labels[s:s + step].long()],
                                zt3[s:s + step])
                   for s in range(0, zh3.shape[0], step)]
            return torch.cat(out).reshape(-1) if out else z_head.new_zeros(0)
        out = []
        for s in range(0, z_head.shape[0], self.TRIPLE_CHUNK):
            e = s + self.TRIPLE_CHUNK
            w = w_sym[labels[s:e].long()]  # [C, D, D]
            out.append(torch.einsum("td,tde,te->t", z_head[s:e], w,
                                    z_tail[s:e]))
        return torch.cat(out) if out else z_head.new_zeros((0,))

    # triples_indexed chunk: its [C, D] f32 gathers are 64 MB at D = 128
    INDEXED_CHUNK = 131072
