"""Graph-parallel KG message passing: every edge type's edges split over a
mesh axis (port of `madrigal_tpu/parallel/kg_shard.py`).

The full-KG HGT pass is the largest encoder cost at PrimeKG scale, and
under plain data parallelism every rank would redo it. Here each rank
holds a contiguous share of every edge type's edge arrays (the node
tables and the weights are replicated), gathers, scores and aggregates
only its share, and the per-destination softmax statistics and message
sums merge over the axis's process group (`ops/segment.py` `group=`,
`parallel/collectives.py`). The source-sorted layouts are dropped first:
they index the global edge axis, so a sharded HGT's gather backward is
the plain one and K2 does not run. Gradients: each rank's backward
leaves every replicated weight a share of the global gradient, summed
once by the trainers' all-reduce (`collectives` module docstring), so the
encoder weights get exactly the full-graph gradients.

The JAX package's degree-chunked (ELL) layout is not ported, so
`pad_kg_edges_to_multiple` pads the plain layout only.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch

from ..data.kg import HeteroKGBatch


def strip_src_arenas(kg: HeteroKGBatch) -> HeteroKGBatch:
    """Drop the source-sorted layouts (K2's), which index the GLOBAL edge
    axis, before sharding."""
    if kg.edge_src_order or kg.edge_src_starts:
        return dataclasses.replace(kg, edge_src_order={}, edge_src_starts={})
    return kg


def pad_kg_edges_to_multiple(kg: HeteroKGBatch, m: int) -> HeteroKGBatch:
    """Re-pad every edge type's arrays to a multiple of `m` rows, so each
    of m shards is equal. Padding rows carry src = dst = 0 with mask
    False; the segment ops drop them, so the numerics are unchanged. Also
    strips the source-sorted layouts (strip_src_arenas)."""
    kg = strip_src_arenas(kg)
    if m <= 1:
        return kg
    src_d, dst_d, mask_d = {}, {}, {}
    for k, src in kg.edge_src.items():
        pad = (-src.shape[0]) % m
        src_d[k] = torch.cat([src, src.new_zeros((pad,))])
        dst_d[k] = torch.cat([kg.edge_dst[k],
                              kg.edge_dst[k].new_zeros((pad,))])
        mask_d[k] = torch.cat([kg.edge_mask[k],
                               kg.edge_mask[k].new_zeros((pad,))])
    return dataclasses.replace(kg, edge_src=src_d, edge_dst=dst_d,
                               edge_mask=mask_d)


def kg_partition_specs(kg: HeteroKGBatch, axis: str) -> dict:
    """Which of a KG batch's fields split over `axis` (the edge arrays)
    and which are replicated (None: node tables, the drug index map)."""
    return {"node_feats": {k: None for k in kg.node_feats},
            "edge_src": {k: axis for k in kg.edge_src},
            "edge_dst": {k: axis for k in kg.edge_dst},
            "edge_mask": {k: axis for k in kg.edge_mask},
            "drug_index_map": None}


def device_put_kg_sharded(kg: HeteroKGBatch, mesh, axis: str,
                          device=None) -> HeteroKGBatch:
    """This rank's share of `kg` (every rank passes the same batch): each
    edge type's arrays padded to a multiple of the axis size and cut to
    the rank's contiguous part; node tables and the drug index map whole.
    Everything is moved to `device` (default: the rank's)."""
    from .mesh import axis_rank, axis_size
    from .multihost import rank_device

    dev = torch.device(device) if device is not None else rank_device()
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    kg = pad_kg_edges_to_multiple(kg, n)

    def place(t, spec):
        if spec is None:
            return t.to(dev)
        per = t.shape[0] // n
        return t[r * per:(r + 1) * per].to(dev)

    fields = {}
    for name, spec in kg_partition_specs(kg, axis).items():
        value = getattr(kg, name)
        fields[name] = (place(value, spec) if not isinstance(spec, dict)
                        else {k: place(value[k], s) for k, s in spec.items()})
    return dataclasses.replace(kg, **fields)


def sharded_kg_apply(mesh, apply_fn: Callable, axis: str = "dp"
                     ) -> Callable:
    """Wrap `apply_fn(kg) -> output` to run graph-parallel.

    `apply_fn` must run an HGT whose convs have `shard_axis == axis`
    (make_sharded_kg_table_fn builds one). The returned callable takes
    the whole KG batch (the same on every rank), runs `apply_fn` on this
    rank's share, and returns its output, which is replicated."""

    def wrapped(kg: HeteroKGBatch):
        return apply_fn(device_put_kg_sharded(kg, mesh, axis))

    return wrapped


def _sharded_hgt(hgt: torch.nn.Module, axis: str) -> torch.nn.Module:
    """A twin of an HGTEncoder sharing its parameters whose convs merge
    over `axis` (the JAX package clones the model with hgt.shard_axis
    set; the parameters apply unchanged)."""
    from ..models.hgt import HGTConv

    twin = copy.copy(hgt)
    twin._modules = dict(hgt._modules)
    for name, mod in hgt._modules.items():
        if isinstance(mod, HGTConv):
            conv = copy.copy(mod)
            conv.shard_axis = axis
            twin._modules[name] = conv
    return twin


def make_sharded_kg_table_fn(model, mesh, axis: str = "dp",
                             encoder_attr: str = "encoder") -> Callable:
    """Graph-parallel `kg_drug_table` of a model holding a MadrigalEncoder
    under `encoder_attr` ('encoder' for MadrigalMultilabel,
    'base_encoder' for SimCLRModel): fn(kg_share) -> [N_kg_drugs, D], the
    drug-node table, replicated, where kg_share is this rank's share
    (device_put_kg_sharded). The model's own parameters are used."""
    from .mesh import axis_group

    enc = getattr(model, encoder_attr)
    if enc.cfg.kg_encoder != "hgt":
        # only the HGT conv merges its segment reductions across edge
        # shards; HAN/RGCN would aggregate each rank's partial graph
        raise ValueError(
            "graph-parallel KG sharding requires kg_encoder='hgt' "
            f"(got '{enc.cfg.kg_encoder}': HAN/RGCN segment ops "
            "do not merge across edge shards)"
        )
    axis_group(axis, mesh)  # the axis must exist
    twin = _sharded_hgt(enc.kg_encoder, axis)

    def table_fn(kg: HeteroKGBatch) -> torch.Tensor:
        return twin(kg)["drug"]

    return table_fn


@torch.no_grad()
def sharded_kg_drug_table(mesh, model, kg: HeteroKGBatch,
                          axis: str = "dp",
                          encoder_attr: str = "encoder") -> np.ndarray:
    """One graph-parallel drug-table forward (serving path) from the whole
    KG batch; the [N_kg_drugs, D] table on every rank."""
    fn = sharded_kg_apply(
        mesh, make_sharded_kg_table_fn(model, mesh, axis, encoder_attr),
        axis)
    return fn(kg).cpu().numpy()
