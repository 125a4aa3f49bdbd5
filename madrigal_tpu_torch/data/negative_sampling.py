"""Structured negative sampling for multilabel DDI edges.

Host-side numpy implementation mirroring the reference's semantics
(reference: madrigal/data/data_utils.py:168-276): for each positive
(label, head, tail), draw corrupted tails (and heads when `two_sided`) from
`valid_negative_nodes`, rejecting any candidate that collides with a known
true triple (either direction), a self-loop, or any other ground-truth
triple -- via integer-encoded triple sets + rejection resampling.

Note: the reference chooses its positional base as
min(num_labels, num_nodes)+1 (data_utils.py:210-214), which can alias
distinct triples when labels overflow the base; we always use
base = num_nodes + 1, which is collision-free.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _encode(label, head, tail, base):
    return (label.astype(np.int64) * base + head.astype(np.int64)) * base + \
        tail.astype(np.int64)


def structured_negative_sampling_multilabel(
    edge_index: np.ndarray,  # [2, E]
    label: np.ndarray,  # [E]
    valid_negative_nodes: Optional[np.ndarray] = None,
    other_ground_truth_edge_index: Optional[np.ndarray] = None,
    other_ground_truth_label: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
    contains_neg_self_loops: bool = False,
    two_sided: bool = True,
    probs: Optional[np.ndarray] = None,
    rng: Optional[np.random.RandomState] = None,
    max_iters: int = 1000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (neg_heads, neg_tails); neg_heads is None if not two_sided."""
    rng = rng or np.random.RandomState()
    head, tail = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    label = np.asarray(label)
    if num_nodes is None:
        num_nodes = int(max(edge_index.max(),
                            0 if other_ground_truth_edge_index is None
                            else other_ground_truth_edge_index.max())) + 1
    base = num_nodes + 1

    if valid_negative_nodes is None:
        valid_negative_nodes = (
            np.unique(edge_index) if two_sided else np.unique(edge_index[1])
        )
    valid_negative_nodes = np.asarray(valid_negative_nodes)

    forbidden = [_encode(label, head, tail, base)]
    if two_sided:
        forbidden.append(_encode(label, tail, head, base))
    if other_ground_truth_edge_index is not None:
        gh, gt = other_ground_truth_edge_index
        gl = other_ground_truth_label
        forbidden.append(_encode(gl, gh, gt, base))
        if two_sided:
            forbidden.append(_encode(gl, gt, gh, base))
    forbidden = np.unique(np.concatenate(forbidden))

    def sample_until_clean(fixed_other, corrupt_side):
        """corrupt_side: 'tail' -> encode (l, head, cand); 'head' ->
        (l, cand, tail). Self-loops rejected directly (no giant loop set)."""
        n = head.shape[0]
        cand = rng.choice(valid_negative_nodes, size=n, replace=True, p=probs)
        for _ in range(max_iters):
            if corrupt_side == "tail":
                enc = _encode(label, head, cand, base)
                loops = (cand == head) if not contains_neg_self_loops else False
            else:
                enc = _encode(label, cand, tail, base)
                loops = (cand == tail) if not contains_neg_self_loops else False
            bad = np.isin(enc, forbidden)
            if not contains_neg_self_loops:
                bad = bad | loops
            rest = np.nonzero(bad)[0]
            if rest.size == 0:
                return cand
            cand[rest] = rng.choice(
                valid_negative_nodes, size=rest.size, replace=True, p=probs
            )
        raise RuntimeError("negative sampling did not converge")

    neg_tails = sample_until_clean(head, "tail")
    neg_heads = sample_until_clean(tail, "head") if two_sided else None
    return neg_heads, neg_tails


def structured_negative_sampling_binary(
    edge_index, valid_negative_nodes=None, other_ground_truth_edge_index=None,
    num_nodes=None, contains_neg_self_loops=False, two_sided=True, probs=None,
    rng=None,
):
    """Binary (single-label) variant (reference data_utils.py:77-166)."""
    e = np.asarray(edge_index)
    labels = np.zeros(e.shape[1], dtype=np.int64)
    gt_l = (
        np.zeros(other_ground_truth_edge_index.shape[1], dtype=np.int64)
        if other_ground_truth_edge_index is not None else None
    )
    return structured_negative_sampling_multilabel(
        e, labels, valid_negative_nodes, other_ground_truth_edge_index, gt_l,
        num_nodes, contains_neg_self_loops, two_sided, probs, rng,
    )
