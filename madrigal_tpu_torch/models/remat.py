"""Rematerialization: a function's activations recomputed in the backward
instead of kept (`torch.utils.checkpoint`, non-reentrant), under the JAX
package's policies (`jax.checkpoint_policies`)."""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint as ckpt

_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """JAX's `dots_with_no_batch_dims_saveable`: keep the 2-D matmuls."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, *args, policy: str | None = None):
    """fn(*args), its activations recomputed in the backward under
    `policy` (None | 'dots'); outside autograd, fn(*args)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saveable)
    elif policy is not None:
        raise ValueError(f"unknown remat_policy {policy!r} (None | 'dots')")
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
