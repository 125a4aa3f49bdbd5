"""Heterogeneous Graph Transformer KG encoder, forward (port of
`madrigal_tpu/models/hgt.py`; reference PyG HGTConv stack,
models.py:71-96).

Per layer:
  per node type t:  [k|q|v] = x_t @ W_kqv_t            ([N_t, 3F], H heads)
  per edge type r = (s, rel, d), per head h:
      k' = k_s @ K_rel[r, h],  v' = v_s @ V_rel[r, h]
      alpha_e = (q_d[dst_e] . k'[src_e]) * p_rel[r, h] / sqrt(D)
  softmax per edge type (softmax_scope 'per_edge_type', the only scope
  kept), then the group aggregate ('sum' | 'mean' | 'max') over edge
  types.
  per node type t:  out = a_lin_t(gelu(m_t)); g = sigmoid(skip_t);
                    out = g * out + (1 - g) * x_t   (when widths match)

This is the plain per-head math. The JAX package's block-diagonal
relation matmul and indicator-matmul head logits are TPU lane-layout
forms of the same sums (hgt.py:70-121). As there, k' and v' are gathered
by edge source once, from the fused [N_src, 2F] table.

Every sum (the softmax denominators, the message sums) and the backward
of every gather (`q[dst]` and the fused source gather) runs on
`ops/segment.py`'s float64 sums, where the port runs kernel K2. With
`remat_edge_types` each edge type's messages are recomputed in the
backward, so only its [N_dst, F] aggregate is kept, not its [E, ...]
edge buffers.

With `compute_dtype='bfloat16'` (hgt.py:87-97, 124-176) the relation
transforms, the fused k|v gather, the logits product and the weighted
messages run in bf16; the head-logit sums, the segment softmax and the
output accumulation stay float32. With 'float32' (the configurations')
no cast is inserted.

"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import HGTConfig
from ..data.kg import EdgeType, HeteroKGBatch, edge_key
from ..ops.segment import gather_rows
from ..ops.segment import segment_softmax, segment_sum
from .attention import reduced_dtype
from .remat import remat


def _src_gather(table: torch.Tensor, g: HeteroKGBatch, ek: str
                ) -> torch.Tensor:
    """`table[src]` for edge type `ek`, with the float64 transpose."""
    return gather_rows(table, g.edge_src[ek])


def _dst_gather(table: torch.Tensor, g: HeteroKGBatch,
                ek: str) -> torch.Tensor:
    """`table[dst]` for edge type `ek`, with the float64 transpose."""
    return gather_rows(table, g.edge_dst[ek])


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
                 remat_edge_types: bool = False,
                 compute_dtype: str | None = "float32"):
        super().__init__()
        self.cast, self.up = _casters(compute_dtype)
        self.remat_edge_types = remat_edge_types
        F_ = out_channels
        if F_ % heads:
            raise ValueError(f"out_channels {F_} not divisible by {heads}")
        if softmax_scope != "per_edge_type":
            raise NotImplementedError(softmax_scope)
        if group not in ("sum", "mean", "max"):
            raise NotImplementedError(group)
        self.F, self.H, self.D = F_, heads, F_ // heads
        self.group = group
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
        kv = _src_gather(torch.cat([k_s, v_s], dim=-1), g, ek)  # [E, 2F]
        prod = _dst_gather(cast(q[dst_t]), g, ek) * kv[:, :self.F]  # [E, F]
        logits = (self.up(prod).reshape(-1, self.H, self.D).sum(-1)
                  * getattr(self, f"p_rel__{ek}")[None, :]
                  / math.sqrt(self.D))
        return logits, kv[:, self.F:]

    def _aggregate(self, logits, vals, dst, mask, n_dst):
        """The softmax of [E, H] logits per destination and the sum of the
        [E, F] values weighted by it."""
        alpha = segment_softmax(logits, dst, n_dst, mask=mask)  # [E, H]
        msg = (vals.reshape(-1, self.H, self.D)
               * self.cast(alpha)[..., None]).reshape(-1, self.F)
        return segment_sum(self.up(msg), dst, n_dst)

    def forward(self, g: HeteroKGBatch, x_dict: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        k_dict, q_dict, v_dict = {}, {}, {}
        for nt in self.node_types:
            kqv = getattr(self, f"kqv__{nt}")(x_dict[nt])
            k_dict[nt], q_dict[nt], v_dict[nt] = kqv.split(self.F, dim=-1)

        agg: Dict[str, list] = {nt: [] for nt in self.node_types}
        for et in self.edge_types:
            src_t, _, dst_t = et
            ek = edge_key(et)
            mask = g.edge_mask[ek]
            n_dst = g.num_nodes(dst_t)
            dst_safe = torch.where(mask, g.edge_dst[ek].long(),
                                   torch.full_like(g.edge_dst[ek].long(),
                                                   n_dst))
            def messages(q, k, v, et=et, dst_safe=dst_safe, mask=mask,
                         n_dst=n_dst):
                logits, vals = self._edge_logits_values(
                    g, et, {et[2]: q}, {et[0]: k}, {et[0]: v})
                return self._aggregate(logits, vals, dst_safe, mask, n_dst)

            args = (q_dict[dst_t], k_dict[src_t], v_dict[src_t])
            agg[dst_t].append(remat(messages, *args)
                              if self.remat_edge_types else messages(*args))

        out_dict = {}
        for nt in self.node_types:
            x = x_dict[nt]
            if not agg[nt]:
                out_dict[nt] = x
                continue
            stacked = torch.stack(agg[nt])
            if self.group == "sum":
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
                           remat_edge_types=cfg.remat_edge_types,
                           compute_dtype=cfg.compute_dtype)
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
