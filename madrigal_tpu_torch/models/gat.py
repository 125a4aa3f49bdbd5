"""Graph Attention Network structure encoder, the alternative to the GIN
(port of `madrigal_tpu/models/gat.py`; reference `--str_encoder gat`,
torchdrug GraphAttentionNetwork, models.py:215, parse_args.py:23-29).

Per layer (GAT v1 with edge-conditioned messages, H heads of D = out / H):

  h = linear(x)                                    (all nodes)
  m_e = h[src_e] + edge_linear(edge_feat_e)        (masked edges: h[src_e])
  logit_e,k = LeakyReLU(att_k . [h[dst_e] || m_e])  (per head k)
  alpha = softmax of the logits over each destination's incoming edges
  out_v = act(BN?(concat_k sum_e alpha_e,k * m_e,k))

Readout: mean (or sum) over each molecule's real atoms. The message
passing runs on the plain segment ops, as the JAX module does: there is
no kernel here.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import BOND_DIM, MOL_DIM
from ..data.molgraph import MolGraphBatch
from ..ops.segment import segment_mean, segment_softmax, segment_sum
from .mlp import activation
from .norm import MaskedBatchNorm


class GATConv(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, num_head: int = 4,
                 negative_slope: float = 0.2, batch_norm: bool = False,
                 actn: str = "relu", edge_input_dim: int = BOND_DIM):
        super().__init__()
        if output_dim % num_head:
            raise ValueError(f"output_dim {output_dim} is not a multiple of "
                             f"num_head {num_head}")
        self.act = activation(actn)
        self.H, self.D = num_head, output_dim // num_head
        self.negative_slope = negative_slope
        self.linear = nn.Linear(input_dim, output_dim)
        self.edge_linear = nn.Linear(edge_input_dim, output_dim)
        self.att = nn.Parameter(torch.empty(num_head, 2 * self.D))
        self.bn = MaskedBatchNorm(output_dim) if batch_norm else None

    def forward(self, g: MolGraphBatch, x: torch.Tensor) -> torch.Tensor:
        n = g.num_nodes_padded
        h = self.linear(x)
        edge_term = self.edge_linear(g.edge_feats).masked_fill(
            ~g.edge_mask.unsqueeze(-1), 0.0)
        msg = h[g.edge_src.long()] + edge_term
        hq = h[g.edge_dst.long()].reshape(-1, self.H, self.D)
        mk = msg.reshape(-1, self.H, self.D)
        logits = F.leaky_relu(
            torch.einsum("ehd,hd->eh", torch.cat([hq, mk], dim=-1), self.att),
            negative_slope=self.negative_slope)
        # padded edges go to the dropped segment id n
        dst = torch.where(g.edge_mask, g.edge_dst.long(),
                          torch.full_like(g.edge_dst.long(), n))
        alpha = segment_softmax(logits, dst, n, mask=g.edge_mask)
        out = segment_sum(mk * alpha.unsqueeze(-1), dst, n).reshape(
            n, self.H * self.D)
        if self.bn is not None:
            out = self.bn(out, mask=g.node_mask)
        return self.act(out)


class GATEncoder(nn.Module):
    """Stacked GATConv layers + per-graph readout. hidden_dims already
    includes the final embedding width (reference models.py:215 appends
    it). Returns (graph_feature [B, D], node_feature [N_pad, D])."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128, 128),
                 num_head: int = 4, negative_slope: float = 0.2,
                 batch_norm: bool = False, actn: str = "relu",
                 readout: str = "mean", input_dim: int = MOL_DIM,
                 edge_input_dim: int = BOND_DIM):
        super().__init__()
        if readout not in ("mean", "sum"):
            raise NotImplementedError(readout)
        self.readout = readout
        self.num_layers = len(hidden_dims)
        dims = [input_dim] + list(hidden_dims)
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", GATConv(
                dims[i], dims[i + 1], num_head=num_head,
                negative_slope=negative_slope, batch_norm=batch_norm,
                actn=actn, edge_input_dim=edge_input_dim))

    def forward(self, g: MolGraphBatch):
        x = g.node_feats
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(g, x)
        node_feature = x.masked_fill(~g.node_mask.unsqueeze(-1), 0.0)
        seg = torch.where(g.node_graph < g.num_graphs, g.node_graph.long(),
                          torch.full_like(g.node_graph.long(), g.num_graphs))
        if self.readout == "mean":
            graph_feature = segment_mean(node_feature, seg, g.num_graphs)
        else:
            graph_feature = segment_sum(node_feature, seg, g.num_graphs)
        return graph_feature, node_feature
