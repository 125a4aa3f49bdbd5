"""Loss functions (port of `madrigal_tpu/train/losses.py`).

* masked_bce: BCE over sigmoid scores on selected triples, matching the
  reference's `torch.sigmoid(model(...))` + `nn.BCELoss` on fancy-indexed
  entries (reference: train_ddi_batch.py:285-351, utils.py:616-625) --
  computed from logits with the numerically stable formulation.
* info_nce: SimCLR contrastive loss with diagonal masking and optional
  too-hard-negative masking (reference: madrigal/models/simclr.py:74-108).
* ce_loss_for_pairs: multiclass cross-entropy over per-pair label logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_bce(logits: torch.Tensor, targets: torch.Tensor,
               weights: torch.Tensor, readout: str = "mean") -> torch.Tensor:
    """Stable BCE-with-logits over rows weighted by `weights` (0/1 mask)."""
    per = F.binary_cross_entropy_with_logits(
        logits, targets.to(logits.dtype), reduction="none")
    w = weights.to(logits.dtype)
    if readout == "mean":
        return (per * w).sum() / w.sum().clamp_min(1.0)
    return (per * w).sum()


def info_nce(aug1: torch.Tensor, aug2: torch.Tensor, temperature: float,
             too_hard_neg_mask=None):
    """SimCLR InfoNCE (simclr.py:74-108): [aug1; aug2] L2-normalized, the
    diagonal dropped, positives at (i, i + B). Returns (logits
    [2B, 2B - 1], positives one-hot, loss)."""
    n = aug1.shape[0]
    feats = torch.cat([aug1, aug2])
    feats = feats / feats.norm(dim=1, keepdim=True)
    sim = feats @ feats.T
    if too_hard_neg_mask is not None:
        sim = sim.masked_fill(too_hard_neg_mask.repeat(2, 2), -1e9)
    labels = torch.arange(n, device=sim.device).repeat(2)
    pos = (labels[None, :] == labels[:, None]).to(sim.dtype)
    keep = ~torch.eye(2 * n, dtype=torch.bool, device=sim.device)
    sim_nd = sim[keep].reshape(2 * n, 2 * n - 1)
    pos_nd = pos[keep].reshape(2 * n, 2 * n - 1)
    logits = sim_nd / temperature
    loss = -(pos_nd * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    return logits, pos_nd, loss


def ce_loss_for_pairs(logits_all_labels: torch.Tensor, labels: torch.Tensor,
                      weights: torch.Tensor, readout: str = "mean"
                      ) -> torch.Tensor:
    """Multiclass cross-entropy over [T, L] per-pair logits (reference
    get_loss_fn 'ce', utils.py:620-622), rows weighted by `weights`."""
    per = F.cross_entropy(logits_all_labels, labels.long(), reduction="none")
    w = weights.to(per.dtype)
    if readout == "mean":
        return (per * w).sum() / w.sum().clamp_min(1.0)
    return (per * w).sum()
