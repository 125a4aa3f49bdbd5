"""Heterogeneous Graph Transformer KG encoder, forward (port of
`madrigal_tpu/models/hgt.py`; reference PyG HGTConv stack,
models.py:71-96).

Per layer:
  per node type t:  [k|q|v] = x_t @ W_kqv_t            ([N_t, 3F], H heads)
  per edge type r = (s, rel, d), per head h:
      k' = k_s @ K_rel[r, h],  v' = v_s @ V_rel[r, h]
      alpha_e = (q_d[dst_e] . k'[src_e]) * p_rel[r, h] / sqrt(D)
  softmax_scope 'per_edge_type': softmax per edge type, then the group
  aggregate ('sum' | 'mean' | 'max') over edge types; 'global': one
  softmax over all incoming edges of a destination across edge types.
  per node type t:  out = a_lin_t(gelu(m_t)); g = sigmoid(skip_t);
                    out = g * out + (1 - g) * x_t   (when widths match)

This is the plain per-head math. The JAX package's block-diagonal
relation matmul and indicator-matmul head logits are TPU lane-layout
forms of the same sums (hgt.py:70-121). As there, k' and v' are gathered
by edge source once, from the fused [N_src, 2F] table.

Every sum runs on kernel K2 when the KG batch carries the sorted layouts
(`data/kg.py`, built by default): the softmax denominators and message
sums over each edge type's destination boundary table (the global scope
over its destination type's order), and the backward of the gathers
`q[dst]` (over the same table, `ops/gather.py` with no order) and of the
source gather (over the source-sorted layout, when the batch has it and
`src_sorted_bwd` is on). So a forward, a backward and an export give the
same bits on every run. Without the layouts, or with src_sorted_bwd off
for the source gather, the plain ops run, whose CUDA backward adds with
atomics in an order that changes from run to run. With
`remat_edge_types` (per_edge_type scope only, as in the JAX package)
each edge type's messages are recomputed in the backward, on the same
layouts, so only its [N_dst, F] aggregate is kept, not its [E, ...]
edge buffers.

With `compute_dtype='bfloat16'` (hgt.py:87-97, 124-176) the relation
transforms, the fused k|v gather, the logits product and the weighted
messages run in bf16; the head-logit sums, the segment softmax and the
output accumulation stay float32: K2 takes the bf16 messages and sums
them in f32, and the gathers' backward hands it bf16 rows. With
'float32' no cast is inserted.

With `shard_axis` (the mesh axis of `parallel/mesh.py`; hgt.py:272-280
and 355-370 of the JAX package) the conv runs graph-parallel: the KG
batch holds this rank's share of every edge type's edges with the
share's own layouts (`parallel/kg_shard.py`), and the segment softmax
and sum merge each rank's K2 sums over the axis's group. Node tables and
weights are replicated.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import HGTConfig
from ..data.kg import EdgeType, HeteroKGBatch, edge_key
from ..ops.gather import gather_rows_sorted
from ..ops.segment import segment_softmax, segment_sum
from .attention import reduced_dtype
from .remat import remat


def _src_gather(table: torch.Tensor, g: HeteroKGBatch, ek: str,
                src_sorted_bwd: bool) -> torch.Tensor:
    """`table[src]` for edge type `ek` (port of hgt.py:47-67). Its backward
    is the sorted segment sum K2 when the batch carries the source-sorted
    layout and src_sorted_bwd is on (on the card K2 raises on a table it
    cannot take; it takes every float32, bfloat16 and float16 width, where
    the JAX package gates the Pallas kernel on the TPU's 128 lanes).
    Otherwise the plain gather."""
    order = g.edge_src_order.get(ek)
    if src_sorted_bwd and order is not None:
        return gather_rows_sorted(table, g.edge_src[ek], order,
                                  g.edge_src_starts[ek])
    return table[g.edge_src[ek].long()]


def _dst_gather(table: torch.Tensor, g: HeteroKGBatch,
                ek: str) -> torch.Tensor:
    """`table[dst]` for edge type `ek`: with the destination boundary
    table, a gather whose backward is K2 over the sorted edges."""
    starts = g.edge_dst_starts.get(ek)
    if starts is not None:
        return gather_rows_sorted(table, g.edge_dst[ek], None, starts)
    return table[g.edge_dst[ek].long()]


def _casters(compute_dtype):
    """(cast, up) of the reduced-precision edge pipeline (port of
    hgt.py:87-97): None or 'float32' inserts no casts at all, so the
    float32 path is unchanged; 'bfloat16' (or 'float16') casts the edge
    streams down and `up` restores float32 for the softmax statistics and
    the accumulation."""
    dtype = reduced_dtype(compute_dtype)
    if dtype is None:
        return (lambda x: x), (lambda x: x)
    return (lambda x: x.to(dtype)), (lambda x: x.float())


def _relation_transform(x: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """[N, H*D] @ per-head [H, D, D] -> [N, H*D]."""
    H, D, _ = rel.shape
    return torch.einsum("nhd,hde->nhe", x.reshape(-1, H, D), rel).reshape(
        -1, H * D)


class HGTConv(nn.Module):
    def __init__(self, in_dims: Dict[str, int], edge_types: Sequence[EdgeType],
                 out_channels: int, heads: int, group: str = "sum",
                 softmax_scope: str = "per_edge_type",
                 src_sorted_bwd: bool = True, remat_edge_types: bool = False,
                 compute_dtype: str | None = "float32",
                 shard_axis: str | None = None):
        super().__init__()
        self.cast, self.up = _casters(compute_dtype)
        self.src_sorted_bwd = src_sorted_bwd
        self.remat_edge_types = remat_edge_types
        self.shard_axis = shard_axis
        F_ = out_channels
        if F_ % heads:
            raise ValueError(f"out_channels {F_} not divisible by {heads}")
        if softmax_scope not in ("per_edge_type", "global"):
            raise NotImplementedError(softmax_scope)
        if group not in ("sum", "mean", "max"):
            raise NotImplementedError(group)
        self.F, self.H, self.D = F_, heads, F_ // heads
        self.group = group
        self.softmax_scope = softmax_scope
        self.node_types = tuple(sorted(in_dims))
        self.edge_types = tuple(tuple(e) for e in edge_types)
        self.dst_types = {et[2] for et in self.edge_types}
        for nt in self.node_types:
            self.add_module(f"kqv__{nt}", nn.Linear(in_dims[nt], 3 * F_))
        for et in self.edge_types:
            ek = edge_key(et)
            self.register_parameter(f"k_rel__{ek}", nn.Parameter(
                torch.empty(heads, self.D, self.D)))
            self.register_parameter(f"v_rel__{ek}", nn.Parameter(
                torch.empty(heads, self.D, self.D)))
            self.register_parameter(f"p_rel__{ek}",
                                    nn.Parameter(torch.ones(heads)))
        for nt in self.node_types:
            if nt not in self.dst_types:
                continue  # no incoming edges: the node keeps its input
            self.add_module(f"out__{nt}", nn.Linear(F_, F_))
            if in_dims[nt] == F_:
                self.register_parameter(f"skip__{nt}",
                                        nn.Parameter(torch.ones(1)))
        self.out_dims = {nt: (F_ if nt in self.dst_types else in_dims[nt])
                         for nt in self.node_types}

    def _group(self):
        """The shard axis's process group (None when not sharded)."""
        if self.shard_axis is None:
            return None
        from ..parallel.mesh import axis_group

        return axis_group(self.shard_axis)

    def _edge_logits_values(self, g: HeteroKGBatch, et: EdgeType,
                            q: Dict[str, torch.Tensor],
                            k: Dict[str, torch.Tensor],
                            v: Dict[str, torch.Tensor]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One edge type's per-edge logits [E, H] (float32) and values
        [E, F] (the compute type)."""
        src_t, _, dst_t = et
        ek = edge_key(et)
        cast = self.cast
        k_s = _relation_transform(cast(k[src_t]),
                                  cast(getattr(self, f"k_rel__{ek}")))
        v_s = _relation_transform(cast(v[src_t]),
                                  cast(getattr(self, f"v_rel__{ek}")))
        # one gather of the fused k|v table (a gather of a concatenation
        # is the concatenation of the gathers)
        kv = _src_gather(torch.cat([k_s, v_s], dim=-1), g, ek,
                         self.src_sorted_bwd)  # [E, 2F]
        prod = _dst_gather(cast(q[dst_t]), g, ek) * kv[:, :self.F]  # [E, F]
        logits = (self.up(prod).reshape(-1, self.H, self.D).sum(-1)
                  * getattr(self, f"p_rel__{ek}")[None, :]
                  / math.sqrt(self.D))
        return logits, kv[:, self.F:]

    def _aggregate(self, logits, vals, dst, mask, n_dst, starts=None,
                   order=None):
        """The softmax of [E, H] logits per destination and the sum of the
        [E, F] values weighted by it, under the layout (starts, order) of
        `ops/segment.py` when given: K2 then takes the compute-type
        messages and sums them in f32."""
        group = self._group()
        alpha = segment_softmax(logits, dst, n_dst, mask=mask, group=group,
                                starts=starts, order=order)  # [E, H]
        msg = (vals.reshape(-1, self.H, self.D)
               * self.cast(alpha)[..., None]).reshape(-1, self.F)
        if starts is None:
            msg = self.up(msg)
        return segment_sum(msg, dst, n_dst, group, starts, order)

    def forward(self, g: HeteroKGBatch, x_dict: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        k_dict, q_dict, v_dict = {}, {}, {}
        for nt in self.node_types:
            kqv = getattr(self, f"kqv__{nt}")(x_dict[nt])
            k_dict[nt], q_dict[nt], v_dict[nt] = kqv.split(self.F, dim=-1)

        agg: Dict[str, list] = {nt: [] for nt in self.node_types}
        pending: Dict[str, list] = {nt: [] for nt in self.node_types}
        for et in self.edge_types:
            src_t, _, dst_t = et
            ek = edge_key(et)
            mask = g.edge_mask[ek]
            n_dst = g.num_nodes(dst_t)
            dst_safe = torch.where(mask, g.edge_dst[ek].long(),
                                   torch.full_like(g.edge_dst[ek].long(),
                                                   n_dst))
            if self.softmax_scope == "global":
                logits, vals = self._edge_logits_values(g, et, q_dict,
                                                        k_dict, v_dict)
                pending[dst_t].append((logits, vals, dst_safe, mask))
                continue

            def messages(q, k, v, et=et, dst_safe=dst_safe, mask=mask,
                         n_dst=n_dst, starts=g.edge_dst_starts.get(ek)):
                logits, vals = self._edge_logits_values(
                    g, et, {et[2]: q}, {et[0]: k}, {et[0]: v})
                return self._aggregate(logits, vals, dst_safe, mask, n_dst,
                                       starts)

            args = (q_dict[dst_t], k_dict[src_t], v_dict[src_t])
            agg[dst_t].append(remat(messages, *args)
                              if self.remat_edge_types else messages(*args))

        if self.softmax_scope == "global":
            # one softmax over the concatenation of every edge type's
            # incoming edges per destination node (PyG 2.3 HGTConv); the
            # batch's per-type layout covers that concatenation when the
            # conv's edge types are the batch's, in the same order
            same = self.edge_types == g.metadata.edge_types
            for nt, items in pending.items():
                if items:
                    agg[nt].append(self._aggregate(
                        *(torch.cat([it[i] for it in items]) for i in range(4)),
                        g.num_nodes(nt),
                        g.dst_type_starts.get(nt) if same else None,
                        g.dst_type_order.get(nt) if same else None))

        out_dict = {}
        for nt in self.node_types:
            x = x_dict[nt]
            if not agg[nt]:
                out_dict[nt] = x
                continue
            stacked = torch.stack(agg[nt])
            if self.softmax_scope == "global" or self.group == "sum":
                m = stacked.sum(0)
            elif self.group == "mean":
                m = stacked.mean(0)
            else:
                m = stacked.amax(0)
            out = getattr(self, f"out__{nt}")(F.gelu(m, approximate="none"))
            skip = getattr(self, f"skip__{nt}", None)
            if skip is not None:
                gate = torch.sigmoid(skip)
                out = gate * out + (1.0 - gate) * x
            out_dict[nt] = out
        return out_dict


class HGTEncoder(nn.Module):
    """HGT stack + per-node-type output head (reference HGT class,
    models.py:71-96: relu after conv i for 1 <= i <= num_layers - 2, then
    lin per node type to embed_dim; only 'drug' with drug_only_head)."""

    def __init__(self, cfg: HGTConfig, embed_dim: int,
                 node_dims: Dict[str, int], edge_types: Sequence[EdgeType],
                 drug_only_head: bool = False):
        super().__init__()
        self.num_layers = cfg.num_layers
        dims = dict(node_dims)
        for i in range(cfg.num_layers):
            conv = HGTConv(dims, edge_types, cfg.hidden_dim, cfg.att_heads,
                           group=cfg.group, softmax_scope=cfg.softmax_scope,
                           src_sorted_bwd=cfg.src_sorted_bwd,
                           remat_edge_types=cfg.remat_edge_types,
                           compute_dtype=cfg.compute_dtype,
                           shard_axis=cfg.shard_axis)
            self.add_module(f"conv_{i}", conv)
            dims = conv.out_dims
        self.head_types = (("drug",) if drug_only_head
                           else tuple(sorted(node_dims)))
        for nt in self.head_types:
            self.add_module(f"lin__{nt}", nn.Linear(dims[nt], embed_dim))

    def forward(self, g: HeteroKGBatch) -> Dict[str, torch.Tensor]:
        x = dict(g.node_feats)
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(g, x)
            if 1 <= i <= self.num_layers - 2:
                x = {nt: F.relu(h) for nt, h in x.items()}
        return {nt: getattr(self, f"lin__{nt}")(x[nt])
                for nt in self.head_types}
