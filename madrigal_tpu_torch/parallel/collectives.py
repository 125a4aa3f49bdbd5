"""Collectives with the gradients the sharded paths need.

Gradient bookkeeping, one rule for every sharded path: each rank's
backward leaves, on every replicated intermediate, a share of the
gradient of the global loss (the shares summing to the whole), and on
every tensor only it holds (its edges, its drug rows, its triples), the
whole gradient. `all_reduce_grads` then sums the replicated parameters'
shares once. The Functions here keep that rule:

  * `all_reduce_sum` (forward all-reduce SUM, backward all-reduce SUM):
    the sum of per-rank partials (an edge shard's segment sums, a batch
    shard's statistics) is replicated, so the shares of its gradient are
    summed before they reach each rank's partial, which only that rank
    holds;
  * `all_reduce_max` (no gradient: the softmax's shift, detached);
  * `gather_rows` (forward all-gather along rows, backward this rank's
    rows of the cotangent): for a loss every rank computes whole from
    the gathered rows (stage 2's InfoNCE), where the cotangent each rank
    holds is already the whole. `torch.distributed.nn.functional.
    all_gather` instead sums the cotangents of every rank (and raises on
    a DeviceMesh subgroup's backward).

Two ranks on one card run gloo (NCCL refuses a shared card: "Duplicate
GPU detected"). gloo takes CUDA tensors in every collective used here
(all_reduce SUM and MAX, all_gather, gather, broadcast; checked on the
H100 with torch 2.11), so they are passed as they are; NCCL needs them
on the rank's card, and host tensors are moved there for it.
"""
from __future__ import annotations

import pickle
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def backend(group=None) -> str:
    return dist.get_backend(group)


def _comm_tensor(t: torch.Tensor, group) -> torch.Tensor:
    """`t` where the group's backend can read it (NCCL: the rank's
    card)."""
    if backend(group) == "nccl" and t.device.type != "cuda":
        from .multihost import rank_device

        return t.to(rank_device())
    return t


def all_gather_tensor(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` (one shape on all ranks) concatenated along the
    first axis in group-rank order, on `t`'s device; no gradient."""
    c = _comm_tensor(t.contiguous(), group)
    parts = [torch.empty_like(c) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, c, group=group)
    return torch.cat(parts).to(t.device)


def gather_tensors(t: torch.Tensor, group=None) -> Optional[list]:
    """Every rank's `t` (one shape on all ranks), in group-rank order, on
    the group's first rank (None elsewhere), on the device the backend
    gathers on (`t`'s, or the card's with NCCL)."""
    c = _comm_tensor(t.contiguous(), group)
    dst = dist.get_global_rank(group, 0) if group is not None else 0
    first = dist.get_rank(group) == 0
    parts = ([torch.empty_like(c) for _ in range(dist.get_world_size(group))]
             if first else None)
    dist.gather(c, parts, dst=dst, group=group)
    return parts


def all_gather_object(obj, group=None) -> list:
    """Every rank's picklable `obj`, in group-rank order (through a byte
    tensor, so it runs on either backend)."""
    from .multihost import rank_device

    dev = (rank_device() if backend(group) == "nccl"
           else torch.device("cpu"))
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    n = torch.tensor([data.numel()], device=dev)
    sizes = all_gather_tensor(n, group).tolist()
    buf = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    buf[:data.numel()] = data.to(dev)
    got = all_gather_tensor(buf[None], group).cpu()
    return [pickle.loads(got[i, :s].numpy().tobytes())
            for i, s in enumerate(sizes)]


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None
                ) -> torch.Tensor:
    """In-place all-reduce of `t`; returns it."""
    c = _comm_tensor(t, group)
    dist.all_reduce(c, op=op, group=group)
    if c is not t:
        t.copy_(c)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), group=ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's `x` over `group`, differentiable (see the
    module docstring); `group=None` returns `x` unchanged."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum over `group` of a tensor that carries no
    gradient; `group=None` returns `x`."""
    if group is None:
        return x
    return all_reduce_(x.clone(), op=dist.ReduceOp.MAX, group=group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        ctx.start = dist.get_rank(group) * x.shape[0]
        return all_gather_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.start:ctx.start + ctx.n].contiguous(), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows `x` [n, ...] (n equal on all ranks) stacked in
    group-rank order [size * n, ...]; the backward hands each rank its
    own rows of the cotangent."""
    if group is None:
        return x
    return _GatherRows.apply(x, group)


def all_reduce_grads(params: Sequence[torch.Tensor], group) -> None:
    """Sum the parameters' gradients over `group` in one collective per
    dtype (a parameter with no gradient counts as zero)."""
    by_dtype = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        all_reduce_(flat, group=group)
        off = 0
        for p in ps:
            n = p.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n


def broadcast_tensors(tensors: Sequence[torch.Tensor], group=None,
                      src_rank: int = 0) -> None:
    """Copy group rank `src_rank`'s values of `tensors` (parameters,
    buffers or plain tensors) to every rank, in place."""
    src = (dist.get_global_rank(group, src_rank) if group is not None
           else src_rank)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():  # one collective per dtype
        flat = _comm_tensor(torch.cat([t.data.reshape(-1) for t in ts]),
                            group)
        dist.broadcast(flat, src=src, group=group)
        off = 0
        for t in ts:
            n = t.numel()
            t.data.copy_(flat[off:off + n].view_as(t.data))
            off += n
