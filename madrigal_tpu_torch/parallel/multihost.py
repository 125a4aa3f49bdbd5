"""Process-group set-up, the hybrid mesh and host-local shards (port of
`madrigal_tpu/parallel/multihost.py`).

One process per rank, as torchrun starts them:

* `initialize()` joins the process group (a no-op when it is already
  initialized) and binds the rank's device: `cuda:(local_rank %
  device_count)`, or the CPU when the caller asks for it. NCCL runs
  between cards and gloo on the CPU; gloo also runs on CUDA tensors when
  two ranks share one card, which NCCL refuses (`collectives` stages the
  collectives gloo does not take on CUDA through host memory).
* `hybrid_mesh()` puts `dcn_axis` ('dp') across hosts and the other axes
  inside a host, as the JAX package puts 'dp' on DCN and the rest on ICI.
  A host is a group of LOCAL_WORLD_SIZE consecutive ranks.
* `host_local_array()` is this rank's slice of a dp-sharded array with
  its global offset and shape (the DistributedSampler's replacement:
  each rank loads only its rows).
* `gather_to_all_hosts()` stacks every rank's array on every rank;
  `sync_hosts()` is a barrier.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_device: Optional[torch.device] = None  # bound by initialize()


def rank_device() -> torch.device:
    """The device `initialize` bound to this rank (the current CUDA
    device, or the CPU when no group was initialized here and no card is
    present)."""
    if _device is not None:
        return _device
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_world_size() -> int:
    """Ranks a host: LOCAL_WORLD_SIZE (torchrun sets it), else the whole
    world (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device: Optional[str] = None,
               coordinator_address: Optional[str] = None,
               local_rank: Optional[int] = None) -> torch.device:
    """Join the process group and bind this rank's device; returns it.

    Arguments left out are read from torchrun's environment (MASTER_ADDR
    / MASTER_PORT through `env://`, WORLD_SIZE, RANK, LOCAL_RANK).
    `coordinator_address` ('host:port') is the JAX package's spelling of
    `init_method='tcp://host:port'`. `device` is 'cuda' (the default)
    or 'cpu'; `backend` defaults to nccl on the card and gloo on the CPU.
    The device is bound (torch.cuda.set_device) before anything is
    allocated on it. A no-op, but for returning the device, when the
    group is already initialized."""
    global _device
    if dist.is_initialized():
        return rank_device()
    from ..device import resolve_device

    dev = resolve_device(device or "cuda")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank or 0))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _device = dev
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address
                       else "env://")
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, **kwargs)
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op when none is initialized) and
    forget the current mesh."""
    global _device
    from .mesh import forget_meshes

    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None
    forget_meshes()  # their groups are gone


def _balanced_factors(n: int, k: int) -> list:
    """Split n into k integer factors, product n, sorted ascending (so the
    last factor is the largest). Greedy: assign each prime factor
    (largest first) to the axis with the smallest running product."""
    primes = []
    d, m = 2, n
    while d * d <= m:
        while m % d == 0:
            primes.append(d)
            m //= d
        d += 1
    if m > 1:
        primes.append(m)
    factors = [1] * k
    for p in sorted(primes, reverse=True):
        factors[factors.index(min(factors))] *= p
    return sorted(factors)


def hybrid_mesh(axis_names: Sequence[str] = ("dp", "label"),
                dcn_axis: str = "dp", ici_sizes: Optional[dict] = None):
    """Mesh over every rank: `dcn_axis` crosses hosts, every other axis
    stays within a host. The per-host rank count is split over the other
    axes as evenly as possible (the LAST axis gets the largest factor);
    `ici_sizes={axis: size}` pins an axis. It becomes the current mesh."""
    from .mesh import mesh_of

    n_local = local_world_size()
    n_world = dist.get_world_size()
    if n_world % n_local:
        raise ValueError(f"{n_world} ranks are not whole hosts of "
                         f"{n_local}")
    n_proc = n_world // n_local
    others = [a for a in axis_names if a != dcn_axis]
    shape = {dcn_axis: n_proc}
    if others:
        pinned = {a: s for a, s in (ici_sizes or {}).items() if a in others}
        rem, free = n_local, [a for a in others if a not in pinned]
        for a, s in pinned.items():
            if rem % s:
                raise ValueError(
                    f"ici_sizes[{a!r}]={s} does not divide the per-host "
                    f"device count {n_local} (given {pinned})")
            rem //= s
        if free:
            for a, f in zip(free, _balanced_factors(rem, len(free))):
                shape[a] = f
        elif rem != 1:
            raise ValueError(
                f"ici_sizes {pinned} use only {n_local // rem} of "
                f"{n_local} per-host devices")
        shape.update(pinned)
        # ranks are host-major: [host, other axes...], then the dcn axis
        # moved to its declared place
        ranks = np.arange(n_world).reshape([n_proc]
                                           + [shape[a] for a in others])
        src = [dcn_axis] + others
        ranks = np.moveaxis(ranks, [src.index(a) for a in axis_names],
                            range(len(axis_names)))
    else:
        shape[dcn_axis] = n_world
        ranks = np.arange(n_world)
    return mesh_of(axis_names, ranks)


@dataclasses.dataclass
class HostLocalArray:
    """This rank's rows of an array sharded over a mesh axis: `local`
    holds rows [offset, offset + len(local)) of the `global_shape`
    array."""

    local: np.ndarray
    offset: int
    global_shape: tuple


def host_local_array(mesh, spec, local_shard: np.ndarray) -> HostLocalArray:
    """This rank's slice of the global array sharded on its first axis
    over mesh axis `spec` (a name, or a one-name tuple as the JAX
    PartitionSpec). Ranks along the axis may hold different row counts;
    the offsets follow their order on the axis. Ranks on other axes hold
    the same rows (they are replicas)."""
    from .collectives import all_gather_object
    from .mesh import axis_group

    axis = spec if isinstance(spec, str) else spec[0]
    local_shard = np.asarray(local_shard)
    counts = all_gather_object(int(local_shard.shape[0]),
                               axis_group(axis, mesh))
    me = mesh.get_local_rank(axis)
    return HostLocalArray(local_shard, int(sum(counts[:me])),
                          (int(sum(counts)),) + local_shard.shape[1:])


def gather_to_all_hosts(x) -> np.ndarray:
    """Every rank's `x` (arrays of one shape), stacked on a new first
    axis in rank order, on every rank."""
    from .collectives import all_gather_tensor

    t = torch.as_tensor(np.ascontiguousarray(np.asarray(x)))
    out = all_gather_tensor(t[None], None)
    return out.cpu().numpy()


def sync_hosts(name: str = "barrier") -> None:
    """Barrier over every rank (checkpoint commit points); `name` is for
    the caller's logs, as in the JAX package."""
    del name
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[rank_device().index])
    else:
        dist.barrier()
