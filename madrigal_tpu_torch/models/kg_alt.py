"""The alternative KG encoders, HAN and RGCN (port of
`madrigal_tpu/models/kg_alt.py`; reference `--kg_encoder han*`, PyG
HANConv, models.py:41-68, and the RGCN variant, models.py:99-117).

HANConv (PyG semantics): per edge type, GAT-style node-level attention
with separate source and destination attention vectors gives a
destination embedding; semantic-level attention (q . tanh(W z + b),
averaged over the nodes, softmaxed over the edge types into a node type)
mixes them. A node type that no edge type reaches gets zeros.

RGCN (PyG RGCNConv with bases) over the node types flattened in the
batch's metadata order: per relation r, W_r = sum_b coeffs[r, b] bases[b];
out_v = root(x_v) + sum_r mean (or sum) over the edges of r into v of
x_src @ W_r; then a linear head on the drug rows. Relations are the
batch's edge types in metadata order, matched by position.

Both run on the segment ops of `ops/segment.py`, as the JAX modules do.
When the KG batch carries its K2 layouts (`data/kg.py`), every sum is
kernel K2: HAN's softmax denominators and message sums over each edge
type's destination boundary table, RGCN's per-relation sums over the same
table (a relation's destinations are one node type's block of the
flattened table, so its sums land in that block), and the gathers'
backward (`ops/gather.py`: the destination side over that table, the
source side over the source-sorted layout when the batch has it).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import HANConfig
from ..data.kg import EdgeType, HeteroKGBatch, edge_key
from ..ops.gather import gather_rows_sorted
from ..ops.segment import segment_mean, segment_softmax, segment_sum
from .mlp import activation


def _gather(table: torch.Tensor, g: HeteroKGBatch, ek: str,
            side: str) -> torch.Tensor:
    """`table[edge_src]` (side 'src') or `table[edge_dst]` ('dst') of edge
    type `ek`, with a K2 backward when the batch has that side's layout."""
    idx = getattr(g, f"edge_{side}")[ek]
    starts = getattr(g, f"edge_{side}_starts").get(ek)
    if starts is None:
        return table[idx.long()]
    order = g.edge_src_order[ek] if side == "src" else None
    return gather_rows_sorted(table, idx, order, starts)


class HANConv(nn.Module):
    def __init__(self, in_dims: Dict[str, int], edge_types: Sequence[EdgeType],
                 out_channels: int, heads: int = 4,
                 negative_slope: float = 0.2, dropout: float = 0.0):
        super().__init__()
        if out_channels % heads:
            raise ValueError(f"out_channels {out_channels} is not a "
                             f"multiple of heads {heads}")
        self.F, self.H, self.D = out_channels, heads, out_channels // heads
        self.negative_slope, self.dropout = negative_slope, dropout
        self.node_types = tuple(sorted(in_dims))
        self.edge_types = tuple(tuple(e) for e in edge_types)
        for nt in self.node_types:
            self.add_module(f"proj__{nt}", nn.Linear(in_dims[nt],
                                                     out_channels))
        for et in self.edge_types:
            ek = edge_key(et)
            self.register_parameter(f"att_src__{ek}", nn.Parameter(
                torch.empty(heads, self.D)))
            self.register_parameter(f"att_dst__{ek}", nn.Parameter(
                torch.empty(heads, self.D)))
        self.sem_lin = nn.Linear(out_channels, out_channels)
        self.sem_q = nn.Parameter(torch.empty(out_channels))

    def forward(self, g: HeteroKGBatch, x_dict: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        proj = {nt: getattr(self, f"proj__{nt}")(x_dict[nt]).reshape(
            -1, self.H, self.D) for nt in self.node_types}
        per_type: Dict[str, list] = {nt: [] for nt in self.node_types}
        for et in self.edge_types:
            src_t, _, dst_t = et
            ek = edge_key(et)
            dst = g.edge_dst[ek].long()
            mask = g.edge_mask[ek]
            n_dst = g.num_nodes(dst_t)
            starts = g.edge_dst_starts.get(ek)
            x_src = _gather(proj[src_t], g, ek, "src")
            logits = F.leaky_relu(
                torch.einsum("ehd,hd->eh", x_src,
                             getattr(self, f"att_src__{ek}"))
                + torch.einsum("ehd,hd->eh", _gather(proj[dst_t], g, ek, "dst"),
                               getattr(self, f"att_dst__{ek}")),
                negative_slope=self.negative_slope)
            dst_safe = torch.where(mask, dst, torch.full_like(dst, n_dst))
            alpha = segment_softmax(logits, dst_safe, n_dst, mask=mask,
                                    starts=starts)
            alpha = F.dropout(alpha, self.dropout, self.training)
            per_type[dst_t].append(segment_sum(
                x_src * alpha.unsqueeze(-1), dst_safe, n_dst,
                starts=starts).reshape(n_dst, self.F))
        out_dict = {}
        for nt in self.node_types:
            if not per_type[nt]:
                out_dict[nt] = x_dict[nt].new_zeros(
                    (x_dict[nt].shape[0], self.F))
                continue
            stacked = torch.stack(per_type[nt])  # [R, N, F]
            scores = torch.einsum("rnf,f->rn", torch.tanh(
                self.sem_lin(stacked)), self.sem_q).mean(1)  # [R]
            beta = torch.softmax(scores, dim=0)
            out_dict[nt] = torch.einsum("r,rnf->nf", beta, stacked)
        return out_dict


class HANEncoder(nn.Module):
    """The reference's HAN wrapper (models.py:41-68): convs with a relu
    after conv i for 1 <= i <= num_layers - 2 (the JAX module's placement,
    kept as it is), and a drug-only output linear."""

    def __init__(self, cfg: HANConfig, embed_dim: int,
                 node_dims: Dict[str, int], edge_types: Sequence[EdgeType]):
        super().__init__()
        self.num_layers = cfg.num_layers
        dims = dict(node_dims)
        for i in range(cfg.num_layers):
            self.add_module(f"conv_{i}", HANConv(
                dims, edge_types, cfg.hidden_dim, heads=cfg.att_heads,
                negative_slope=cfg.negative_slope, dropout=cfg.dropout))
            dims = {nt: cfg.hidden_dim for nt in dims}
        self.lin__drug = nn.Linear(dims["drug"], embed_dim)

    def forward(self, g: HeteroKGBatch) -> Dict[str, torch.Tensor]:
        x = dict(g.node_feats)
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(g, x)
            if 1 <= i <= self.num_layers - 2:
                x = {nt: F.relu(h) for nt, h in x.items()}
        return {"drug": self.lin__drug(x["drug"])}


class RGCNEncoder(nn.Module):
    """RGCN with basis decomposition over the flattened heterogeneous graph
    (one relation an edge type). Its weights depend only on the common
    node feature width `in_dim` and the number of relations."""

    def __init__(self, in_dim: int, num_relations: int, hidden_dim: int,
                 embed_dim: int, num_layers: int = 2, num_bases: int = 8,
                 aggr: str = "mean", actn: str = "relu"):
        super().__init__()
        if aggr not in ("mean", "sum"):
            raise NotImplementedError(aggr)
        self.act = activation(actn)
        self.aggr = aggr
        self.num_layers, self.num_relations = num_layers, num_relations
        dims = [in_dim] + [hidden_dim] * num_layers
        for li in range(num_layers):
            self.register_parameter(f"bases_{li}", nn.Parameter(
                torch.empty(num_bases, dims[li], dims[li + 1])))
            self.register_parameter(f"coeffs_{li}", nn.Parameter(
                torch.empty(num_relations, num_bases)))
            self.add_module(f"root_{li}", nn.Linear(dims[li], dims[li + 1]))
        self.lin__drug = nn.Linear(dims[-1], embed_dim)

    def forward(self, g: HeteroKGBatch) -> Dict[str, torch.Tensor]:
        relations = g.metadata.edge_types
        if len(relations) != self.num_relations:
            raise ValueError(f"the KG has {len(relations)} edge types; the "
                             f"RGCN was built for {self.num_relations}")
        offsets, total = {}, 0
        for nt in g.metadata.node_types:
            offsets[nt] = total
            total += g.num_nodes(nt)
        x = torch.cat([g.node_feats[nt] for nt in g.metadata.node_types])
        for li in range(self.num_layers):
            bases = getattr(self, f"bases_{li}")
            coeffs = getattr(self, f"coeffs_{li}")
            agg = x.new_zeros((total, bases.shape[-1]))
            for ri, et in enumerate(relations):
                src_t, _, dst_t = et
                ek = edge_key(et)
                w_r = torch.einsum("b,bio->io", coeffs[ri], bases)
                mask = g.edge_mask[ek]
                reduce = segment_mean if self.aggr == "mean" else segment_sum
                starts = g.edge_dst_starts.get(ek)
                if starts is None:
                    src = g.edge_src[ek].long() + offsets[src_t]
                    dst = g.edge_dst[ek].long() + offsets[dst_t]
                    msg = (x[src] @ w_r).masked_fill(~mask.unsqueeze(-1),
                                                     0.0)
                    dst_safe = torch.where(mask, dst,
                                           torch.full_like(dst, total))
                    agg = agg + reduce(msg, dst_safe, total)
                    continue
                # the relation's sources and destinations are blocks of the
                # flattened table: gather from the source block, sum into
                # the destination block
                lo, n_src = offsets[src_t], g.num_nodes(src_t)
                msg = (_gather(x[lo:lo + n_src], g, ek, "src") @ w_r
                       ).masked_fill(~mask.unsqueeze(-1), 0.0)
                lo, n_dst = offsets[dst_t], g.num_nodes(dst_t)
                part = reduce(msg, g.edge_dst[ek], n_dst, starts=starts)
                agg = agg + F.pad(part, (0, 0, lo, total - lo - n_dst))
            x = getattr(self, f"root_{li}")(x) + agg
            if li < self.num_layers - 1:
                x = self.act(x)
        drug = x[offsets["drug"]:offsets["drug"] + g.num_nodes("drug")]
        return {"drug": self.lin__drug(drug)}
