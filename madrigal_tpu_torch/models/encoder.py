"""MadrigalEncoder and MadrigalMultilabel (port of
`madrigal_tpu/models/encoder.py`; reference NovelDDIEncoder /
NovelDDIMultilabel, models.py:607-953).

Four modality encoders -> [B, NUM_MODALITIES, D] token stack ->
missing-modality-masked transformer fusion with optional tx bottlenecks;
drugs with a single modality take the MLP fuser instead (select-based
routing: both paths run for every row). Drugs absent from the KG get a
zero KG token. The KG table is computed once and shared by every encode.

The structure encoder is the GIN or the GAT (`str_encoder`), the KG
encoder the HGT, HAN or RGCN (`kg_encoder`, 'han' and 'rgcn' matched as
substrings, as the JAX package matches them); only the KG encoder's drug
output reaches the fusion.

Unlike flax, torch modules need their input widths up front: the KG
schema (node feature width per node type, edge types) is a constructor
argument, taken from the dataset (`data.kg.kg_schema`) or from a saved
state_dict (`kg_schema_from_state_dict`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .. import config as config_lib
from ..config import EncoderConfig, MLPEncoderConfig
from ..constants import NUM_CELL_LINES
from ..data.batch import DrugModalityBatch
from ..data.kg import EdgeType, HeteroKGBatch, edge_key
from ..device import resolve_device
from ..utils.profiling import span
from .chemcpa import ChemCPAEncoder
from .decoder import BilinearDDIScorer
from .fusion import PositionEncoding, TransformerFusion, build_bottleneck_masks
from .gat import GATEncoder
from .gin import GINEncoder
from .hgt import HGTEncoder
from .kg_alt import HANEncoder, RGCNEncoder
from .mlp import MLPEncoder


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """torch F.normalize's eps clamp: all-zero rows stay zero."""
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _first_available(all_embeds: torch.Tensor, masks: torch.Tensor):
    """[B, D] token of each drug's first available modality."""
    avail = (~masks).to(all_embeds.dtype)
    onehot = avail * (torch.cumsum(avail, dim=1) == 1.0).to(avail.dtype)
    return torch.einsum("bm,bmd->bd", onehot, all_embeds)


def _mlp(input_dim: int, output_dim: int, mc) -> MLPEncoder:
    return MLPEncoder(input_dim, tuple(mc.hidden_dims), output_dim,
                      dropout=mc.dropout, norm=mc.norm, actn=mc.actn,
                      order=mc.order)


class MadrigalEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, kg_node_dims: Dict[str, int],
                 kg_edge_types: Sequence[EdgeType]):
        super().__init__()
        c = cfg
        self.cfg = c
        if c.fusion not in ("transformer_uni_proj", "transformer", "mean",
                            "add"):
            raise NotImplementedError(c.fusion)
        if c.str_encoder == "gin":
            self.str_encoder = GINEncoder(
                hidden_dims=tuple(c.gin.hidden_dims) + (c.feature_dim,),
                num_mlp_layer=c.gin.num_mlp_layer, eps_init=c.gin.eps,
                learn_eps=c.gin.learn_eps, batch_norm=c.gin.batch_norm,
                actn=c.gin.actn, readout=c.gin.readout,
                input_dim=c.gin.atom_dim, edge_input_dim=c.gin.edge_input_dim)
        elif c.str_encoder == "gat":
            self.str_encoder = GATEncoder(
                hidden_dims=tuple(c.gat.hidden_dims) + (c.feature_dim,),
                num_head=c.gat.att_heads, negative_slope=c.gat.negative_slope,
                batch_norm=c.gat.batch_norm, actn=c.gat.actn,
                readout=c.gat.readout, input_dim=c.gat.atom_dim,
                edge_input_dim=c.gat.edge_input_dim)
        else:
            raise NotImplementedError(c.str_encoder)
        # the KG encoder is chosen as the JAX package chooses it: 'han' and
        # 'rgcn' by substring
        if c.kg_encoder in ("hgt", "hgt_drug_edge_only"):
            self.kg_encoder = HGTEncoder(c.hgt, c.feature_dim, kg_node_dims,
                                         kg_edge_types, drug_only_head=True)
        elif "han" in c.kg_encoder:
            self.kg_encoder = HANEncoder(c.han, c.feature_dim, kg_node_dims,
                                         kg_edge_types)
        elif "rgcn" in c.kg_encoder:
            widths = set(kg_node_dims.values())
            if len(widths) != 1:
                raise ValueError("the RGCN concatenates every node type's "
                                 f"features; their widths differ: "
                                 f"{dict(kg_node_dims)}")
            r = c.rgcn
            self.kg_encoder = RGCNEncoder(
                widths.pop(), len(kg_edge_types), r.hidden_dim,
                c.feature_dim, num_layers=r.num_layers,
                num_bases=r.num_bases, aggr=r.aggr, actn=r.actn)
        else:
            raise NotImplementedError(c.kg_encoder)
        self.cv_encoder = _mlp(c.cv.input_dim, c.feature_dim, c.cv)
        # one MLP a non-tx tabular modality beyond str/kg/cv (the
        # NON_TX_MODALITIES environment variable, e.g. 'bs'); its token
        # follows cv's, in sorted modality order. A config read back from
        # a dict holds each modality's MLPEncoderConfig as a dict.
        self.extra_tabular = sorted(c.extra_tabular)
        for mod in self.extra_tabular:
            mc = c.extra_tabular[mod]
            if not isinstance(mc, MLPEncoderConfig):
                mc = config_lib.from_dict(MLPEncoderConfig, mc)
            self.add_module(f"tab_encoder_{mod}",
                            _mlp(mc.input_dim, c.feature_dim, mc))
        if c.tx_encoder == "chemcpa":
            self.tx_encoder = ChemCPAEncoder(c.chemcpa)
        elif c.tx_encoder == "mlp":
            self.tx_encoder = _mlp(c.tx_mlp.input_dim, c.feature_dim,
                                   c.tx_mlp)
        else:
            raise NotImplementedError(c.tx_encoder)

        num_bt = c.transformer.num_tx_bottlenecks
        if num_bt > 0:
            self.tx_bottleneck_tokens = nn.Parameter(
                torch.empty(num_bt, c.feature_dim))
            self.register_buffer("src_mask", torch.from_numpy(
                build_bottleneck_masks(
                    c.num_non_tx_modalities, num_bt, NUM_CELL_LINES,
                    with_cls=(c.transformer.agg == "cls"))),
                persistent=False)
        else:
            self.src_mask = None
        if c.transformer.agg == "cls":
            self.cls = nn.Parameter(torch.empty(1, c.feature_dim))
        self.pos_encoder = PositionEncoding(
            c.pos_emb_max_len, c.feature_dim, c.pos_emb_type,
            c.pos_emb_dropout)
        self.transformer = TransformerFusion(
            c.transformer, c.feature_dim,
            num_kv_tokens=c.num_modalities + num_bt,
            num_non_tx=c.num_non_tx_modalities)
        self.uni_projector = _mlp(c.feature_dim, c.feature_dim, c.proj)
        if c.fusion == "transformer_uni_proj":
            self.uni_fuser = _mlp(c.feature_dim, c.feature_dim, c.proj)

    def kg_drug_table(self, kg: HeteroKGBatch) -> torch.Tensor:
        """Full-KG message passing once -> drug-node table [N_kg_drugs, D]."""
        with span("madrigal.kg_pass"):
            return self.kg_encoder(kg)["drug"]

    def modality_tokens(self, batch: DrugModalityBatch,
                        kg: Optional[HeteroKGBatch] = None,
                        kg_drug_table: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """[B, NUM_MODALITIES, D] per-modality tokens (models.py:717-775)."""
        c = self.cfg
        str_out, _ = self.str_encoder(batch.mols)
        if kg_drug_table is None:
            if kg is None:
                raise ValueError("need a KG batch or a precomputed drug table")
            kg_drug_table = self.kg_drug_table(kg)
        rows = batch.kg_rows.long().clamp(0, kg_drug_table.shape[0] - 1)
        kg_out = kg_drug_table[rows].masked_fill(
            (batch.kg_rows < 0)[:, None], 0.0)
        cv_out = self.cv_encoder(batch.cv)
        extra_out = [getattr(self, f"tab_encoder_{mod}")(
            batch.extra_tabular[mod]) for mod in self.extra_tabular]

        C, B = batch.tx_sigs.shape[0], batch.batch_size
        if c.tx_encoder == "chemcpa":
            genes = batch.tx_sigs.reshape(C * B, -1)
            cov_idx = torch.arange(C, device=genes.device).repeat_interleave(B)
            use_drugs = c.chemcpa.use_drugs
            tx_tokens = self.tx_encoder(
                genes, cov_idx,
                batch.drugs.repeat(C) if use_drugs else None,
                batch.tx_dosages.reshape(C * B) if use_drugs else None,
                return_basal=c.use_tx_basal).reshape(C, B, -1)
        else:
            tx_tokens = self.tx_encoder(batch.tx_sigs)
        return torch.stack([str_out, kg_out, cv_out] + extra_out
                           + list(tx_tokens), dim=1)

    def forward(self, batch, kg=None, kg_drug_table=None,
                raw_encoder_output: bool = False):
        return self.encode(batch, kg, kg_drug_table,
                           raw_encoder_output=raw_encoder_output)

    def encode(self, batch: DrugModalityBatch,
               kg: Optional[HeteroKGBatch] = None,
               kg_drug_table: Optional[torch.Tensor] = None,
               raw_encoder_output: bool = False) -> torch.Tensor:
        """Fused drug embedding z [B, D]; raw_encoder_output returns the
        projected first-available-modality embedding (the CL path)."""
        tokens = self.modality_tokens(batch, kg, kg_drug_table)
        return self.fuse_tokens(tokens, batch.masks,
                                raw_encoder_output=raw_encoder_output)

    def fuse_tokens(self, all_embeds: torch.Tensor, masks: torch.Tensor,
                    raw_encoder_output: bool = False) -> torch.Tensor:
        """Fuse a [B, NUM_MODALITIES, D] token stack under a modality mask
        (True = missing)."""
        c = self.cfg
        if raw_encoder_output:
            uni = _first_available(all_embeds, masks)
            if c.normalize:
                uni = _l2_normalize(uni)
            return self.uni_projector(uni)
        if c.adapt_before_fusion:
            all_embeds = self.uni_projector(all_embeds)

        if c.fusion in ("mean", "add"):
            e = _l2_normalize(all_embeds) if c.normalize else all_embeds
            keep = (~masks).to(e.dtype)[..., None]
            z = (e * keep).sum(1)
            if c.fusion == "mean":
                z = z / keep.sum(1).clamp_min(1.0)
            return z

        seq, fusion_mask = all_embeds, masks
        B = seq.shape[0]
        num_bt = c.transformer.num_tx_bottlenecks
        if num_bt > 0:
            n = c.num_non_tx_modalities
            bt = self.tx_bottleneck_tokens[None].expand(B, -1, -1)
            seq = torch.cat([seq[:, :n], bt, seq[:, n:]], dim=1)
            fusion_mask = torch.cat(
                [fusion_mask[:, :n],
                 fusion_mask.new_zeros((B, num_bt)), fusion_mask[:, n:]],
                dim=1)
        if c.transformer.agg == "cls":
            seq = torch.cat([self.cls[None].expand(B, -1, -1), seq], dim=1)
            fusion_mask = torch.cat(
                [fusion_mask.new_zeros((B, 1)), fusion_mask], dim=1)
        if c.normalize:
            seq = _l2_normalize(seq)
        seq = self.pos_encoder(seq)
        # each drug's sequence is independent: chunking the drug axis is
        # exact and bounds the latent-width activations
        chunk = c.fusion_batch_chunk or B
        z_fusion = torch.cat([
            self.transformer(seq[s:s + chunk], fusion_mask[s:s + chunk],
                             self.src_mask)
            for s in range(0, B, chunk)])

        if c.fusion == "transformer":
            return z_fusion
        uni = _first_available(all_embeds, masks)
        if c.normalize:
            uni = _l2_normalize(uni)
        z_uni = self.uni_fuser(uni)
        is_multi = (~masks).sum(1) > 1
        return torch.where(is_multi[:, None], z_fusion, z_uni)


class MadrigalMultilabel(nn.Module):
    """Encoder + symmetric bilinear decoder (reference NovelDDIMultilabel,
    models.py:914-953), and with prediction_dim_single_drug a single-drug
    side-effect head on the fused embedding (the ONSIDES path; reference
    models.py:915-921)."""

    def __init__(self, enc_cfg: EncoderConfig, prediction_dim: int,
                 kg_node_dims: Dict[str, int],
                 kg_edge_types: Sequence[EdgeType],
                 decoder_normalize: bool = False,
                 prediction_dim_single_drug: Optional[int] = None):
        super().__init__()
        self.decoder_normalize = decoder_normalize
        self.encoder = MadrigalEncoder(enc_cfg, kg_node_dims, kg_edge_types)
        self.decoder = BilinearDDIScorer(prediction_dim, enc_cfg.feature_dim,
                                         enc_cfg.feature_dim)
        if prediction_dim_single_drug:
            self.single_drug_head = nn.Linear(enc_cfg.feature_dim,
                                              prediction_dim_single_drug)

    def embed_pair(self, head, tail, kg=None, kg_drug_table=None):
        """Encode head and tail batches, sharing one KG message pass."""
        if kg_drug_table is None:
            kg_drug_table = self.encoder.kg_drug_table(kg)
        z_head = self.encoder.encode(head, kg_drug_table=kg_drug_table)
        z_tail = self.encoder.encode(tail, kg_drug_table=kg_drug_table)
        if self.decoder_normalize:
            z_head, z_tail = _l2_normalize(z_head), _l2_normalize(z_tail)
        return z_head, z_tail

    def forward(self, head, tail, kg, label_range=None):
        z_head, z_tail = self.embed_pair(head, tail, kg)
        return self.decoder.all_pairs(z_head, z_tail, label_range)

    def score_triples(self, head, tail, kg, head_idx, tail_idx, labels,
                      kg_drug_table=None, chunk_labels=None,
                      label_chunk: int = 0):
        """Embeds unique heads/tails once and scores only the triples.
        kg_drug_table skips the KG pass (the trainer computes it once per
        step); chunk_labels/label_chunk select the label-chunked layout
        (decoder.triples)."""
        z_head, z_tail = self.embed_pair(head, tail, kg, kg_drug_table)
        return self.decoder.triples(z_head[head_idx.long()],
                                    z_tail[tail_idx.long()], labels,
                                    chunk_labels, label_chunk)

    def score_single_drug(self, batch, kg):
        """[N, L_single] single-drug side-effect logits of a drug batch."""
        table = self.encoder.kg_drug_table(kg)
        z = self.encoder.encode(batch, kg_drug_table=table)
        return self.single_drug_head(z)


def kg_schema_from_state_dict(state_dict: Dict[str, torch.Tensor]):
    """(node feature width per node type, edge types) read back from a
    MadrigalMultilabel state_dict: the first KG layer's per-type input
    projections (HGT `kqv__<type>`, HAN `proj__<type>`) and per-relation
    parameters (HGT `k_rel__<src>__<rel>__<dst>`, HAN `att_src__...`).
    An RGCN's parameters name no type: its schema is one node type,
    'drug', of the common feature width (`bases_0`'s input) and one
    placeholder edge type a relation (`coeffs_0`'s rows), which is all
    that its shapes depend on; it reads the types from the KG batch."""
    pre = "encoder.kg_encoder."
    if pre + "bases_0" in state_dict:
        n_rel = int(state_dict[pre + "coeffs_0"].shape[0])
        return ({"drug": int(state_dict[pre + "bases_0"].shape[1])},
                tuple(("", f"relation_{r}", "") for r in range(n_rel)))
    pre += "conv_0."
    dims, edge_types = {}, []
    for k, v in state_dict.items():
        if not k.startswith(pre):
            continue
        name = k[len(pre):]
        for lin in ("kqv__", "proj__"):
            if name.startswith(lin) and name.endswith(".weight"):
                dims[name[len(lin):-len(".weight")]] = int(v.shape[1])
        for rel in ("k_rel__", "att_src__"):
            if name.startswith(rel):
                edge_types.append(tuple(name[len(rel):].split("__")))
    return dims, tuple(sorted(edge_types))


def _glorot_uniform_(p: torch.Tensor, generator: torch.Generator) -> None:
    """flax's glorot_uniform: fans over the last two axes, times the
    product of the others."""
    field = p[..., 0, 0].numel() if p.dim() > 2 else 1
    fan_in, fan_out = p.shape[-2] * field, p.shape[-1] * field
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    p.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from `generator` with the JAX package's
    initializer families: Dense kernels lecun-normal with zero bias,
    norms ones/zeros, HGT relation matrices, GAT and HAN attention
    vectors and RGCN bases and coefficients glorot-uniform, HAN's
    semantic query normal(0.1), p_rel and skip gates ones, embeddings
    and learned tokens standard normal, the decoder U(-1/sqrt(D),
    1/sqrt(D)). Streams differ from JAX's."""
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, BilinearDDIScorer):
                bound = 1.0 / math.sqrt(p.shape[1])
                p.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, (nn.Linear, nn.Embedding)) and name == "weight":
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]),
                          generator=generator)
            elif name.startswith(("k_rel__", "v_rel__")):
                bound = math.sqrt(6.0 / (p.shape[1] + p.shape[2]))
                p.uniform_(-bound, bound, generator=generator)
            elif name == "att" or name.startswith(
                    ("att_src__", "att_dst__", "bases_", "coeffs_")):
                _glorot_uniform_(p, generator)
            elif name == "sem_q":
                p.normal_(0.0, 0.1, generator=generator)
            elif name == "bias":
                p.zero_()
            elif name == "eps":
                continue  # GIN eps keeps its configured initial value
            elif name in ("weight", "beta") or name.startswith(
                    ("p_rel__", "skip__")):
                p.fill_(1.0)  # norm scales, dosers, HGT gates
            else:
                p.normal_(0.0, 1.0, generator=generator)
    return model


def build_model(model_cfg, kg_node_dims, kg_edge_types,
                device: torch.device | str | None = None
                ) -> MadrigalMultilabel:
    """MadrigalMultilabel from a ModelConfig, in eval mode on `device`
    (None: the card)."""
    device = resolve_device(device)
    model = MadrigalMultilabel(
        model_cfg.encoder, model_cfg.prediction_dim, kg_node_dims,
        kg_edge_types, decoder_normalize=model_cfg.decoder_normalize,
        prediction_dim_single_drug=model_cfg.prediction_dim_single_drug)
    return model.to(device).eval()
