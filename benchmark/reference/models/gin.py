"""Graph Isomorphism Network structure encoder (port of
`madrigal_tpu/models/gin.py`; torchdrug GraphIsomorphismConv semantics).

Per layer:
  message   m_e = x[src_e] + edge_linear(edge_feat_e)
  aggregate a_v = sum_{e: dst_e = v} m_e
  combine   h_v = act(BN(MLP((1 + eps) * x_v + a_v)))
Readout: mean (or sum) over each molecule's real atoms.

The aggregate, the readout and the source gather's backward run on
`ops/segment.py`'s float64 sums, where the port runs kernel K2.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..constants import BOND_DIM, MOL_DIM
from ..data.molgraph import MolGraphBatch
from ..ops.segment import gather_rows, segment_mean, segment_sum
from .mlp import activation
from .norm import MaskedBatchNorm


def src_rows(x: torch.Tensor, g: MolGraphBatch) -> torch.Tensor:
    """`x[edge_src]`, with the float64 transpose."""
    return gather_rows(x, g.edge_src)


def graph_readout(node_feature: torch.Tensor, g: MolGraphBatch,
                  readout: str) -> torch.Tensor:
    """Mean or sum of each graph's atom rows [B, D]; padding atoms belong
    to no graph."""
    seg = torch.where(g.node_graph < g.num_graphs, g.node_graph.long(),
                      torch.full_like(g.node_graph.long(), g.num_graphs))
    reduce = segment_mean if readout == "mean" else segment_sum
    return reduce(node_feature, seg, g.num_graphs)


class GINConv(nn.Module):
    def __init__(self, input_dim: int, output_dim: int,
                 num_mlp_layer: int = 3, eps_init: float = 0.0,
                 learn_eps: bool = True, batch_norm: bool = True,
                 actn: str = "relu", edge_input_dim: int = BOND_DIM):
        super().__init__()
        self.act = activation(actn)
        self.num_mlp_layer = num_mlp_layer
        self.edge_linear = nn.Linear(edge_input_dim, input_dim)
        if learn_eps:
            self.eps = nn.Parameter(torch.full((1,), float(eps_init)))
        else:
            self.register_buffer("eps", torch.full((1,), float(eps_init)),
                                 persistent=False)
        dims = [input_dim] + [output_dim] * num_mlp_layer
        for i in range(num_mlp_layer):
            self.add_module(f"mlp_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.bn = MaskedBatchNorm(output_dim) if batch_norm else None

    def forward(self, g: MolGraphBatch, x: torch.Tensor) -> torch.Tensor:
        msg = src_rows(x, g) + self.edge_linear(g.edge_feats)
        msg = msg.masked_fill(~g.edge_mask.unsqueeze(-1), 0.0)
        # padded edges go to the dropped segment id num_nodes_padded
        dst = torch.where(g.edge_mask, g.edge_dst.long(),
                          torch.full_like(g.edge_dst.long(),
                                          g.num_nodes_padded))
        agg = segment_sum(msg, dst, g.num_nodes_padded)
        h = (1.0 + self.eps) * x + agg
        for i in range(self.num_mlp_layer):
            h = getattr(self, f"mlp_{i}")(h)
            if i < self.num_mlp_layer - 1:
                h = self.act(h)
        if self.bn is not None:
            h = self.bn(h, mask=g.node_mask)
        return self.act(h)


class GINEncoder(nn.Module):
    """Stacked GINConv layers + per-graph readout. hidden_dims already
    includes the final embedding width. Returns (graph_feature [B, D],
    node_feature [N_pad, D])."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128, 128),
                 num_mlp_layer: int = 3, eps_init: float = 0.0,
                 learn_eps: bool = True, batch_norm: bool = True,
                 actn: str = "relu", readout: str = "mean",
                 input_dim: int = MOL_DIM, edge_input_dim: int = BOND_DIM):
        super().__init__()
        if readout not in ("mean", "sum"):
            raise NotImplementedError(readout)
        self.readout = readout
        self.num_layers = len(hidden_dims)
        dims = [input_dim] + list(hidden_dims)
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", GINConv(
                dims[i], dims[i + 1], num_mlp_layer=num_mlp_layer,
                eps_init=eps_init, learn_eps=learn_eps,
                batch_norm=batch_norm, actn=actn,
                edge_input_dim=edge_input_dim))

    def forward(self, g: MolGraphBatch):
        x = g.node_feats
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(g, x)
        node_feature = x.masked_fill(~g.node_mask.unsqueeze(-1), 0.0)
        return graph_readout(node_feature, g, self.readout), node_feature
