"""Device meshes over the initialized process group (port of
`madrigal_tpu/parallel/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose named axes
('dp', 'label', ...) carry one process group each. Placement is which
rank holds which slice, so the JAX package's `replicated` and `sharded`
shardings have no tensor-level counterpart here: `axis_group` looks an
axis's group up by name (the HGT's `shard_axis` and the trainers find
their groups through it), and `axis_size` / `axis_rank` give a rank its
slice.

The last mesh built (`make_mesh`, `multihost.hybrid_mesh`,
`train_step.make_train_mesh`) is the current one, the one `axis_group`
reads unless it is handed another.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_current = None  # the mesh axis_group reads by default
_built = {}  # (device type, axis names, rank layout) -> DeviceMesh


def mesh_device_type() -> str:
    """'cuda' when this rank's work runs on a card, else 'cpu' (as
    `multihost.initialize` bound it)."""
    from .multihost import rank_device

    return rank_device().type


def set_mesh(mesh):
    """Make `mesh` the current mesh; returns it."""
    global _current
    _current = mesh
    return mesh


def current_mesh():
    if _current is None:
        raise RuntimeError("no device mesh: build one with make_mesh (or "
                           "hybrid_mesh / make_train_mesh) first")
    return _current


def make_mesh(axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None):
    """A DeviceMesh over every rank of the initialized group, axes named
    `axis_names`, ranks laid out row-major in `shape` (default: all ranks
    on the first axis). It becomes the current mesh."""
    n = dist.get_world_size()
    if shape is None:
        shape = [n] + [1] * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold the "
                         f"{n} ranks")
    return mesh_of(axis_names, np.arange(n).reshape(shape))


def mesh_of(axis_names: Sequence[str], ranks: np.ndarray):
    """The DeviceMesh of global `ranks` laid out as the array is, axes
    named `axis_names`, made the current mesh. Every rank calls it
    together. A mesh is built once a process group: building one
    creates a process group per axis slice, a collective each."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    key = (mesh_device_type(), tuple(axis_names), ranks.shape,
           tuple(ranks.reshape(-1).tolist()))
    if key not in _built:
        if key[3] == tuple(range(dist.get_world_size())):  # row-major
            mesh = init_device_mesh(key[0], ranks.shape,
                                    mesh_dim_names=tuple(axis_names))
        else:
            mesh = DeviceMesh(key[0], torch.from_numpy(ranks.copy()),
                              mesh_dim_names=tuple(axis_names))
        _built[key] = mesh
    return set_mesh(_built[key])


def forget_meshes() -> None:
    """Drop the built meshes (their process groups are gone)."""
    global _current
    _current = None
    _built.clear()


def axis_group(name: str, mesh=None):
    """The process group of mesh axis `name` that holds this rank."""
    mesh = mesh if mesh is not None else current_mesh()
    return mesh.get_group(name)


def axis_size(mesh, name: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(name)))


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along axis `name`."""
    return int(mesh.get_local_rank(name))


def mesh_shape(mesh) -> dict:
    """{axis name: size}, as the JAX Mesh's `shape`."""
    return {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> Tuple[np.ndarray, int]:
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, 0
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill), pad


def shard_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, end) of part `index` when n rows split into `parts`
    contiguous parts of ceil(n / parts) rows (the last ones shorter)."""
    per = -(-n // parts)
    return min(index * per, n), min((index + 1) * per, n)
