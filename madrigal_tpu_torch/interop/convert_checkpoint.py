"""Full reference-checkpoint conversion (a copy of
`madrigal_tpu/interop/convert_checkpoint.py`, numpy only, reading the
port's `data.kg.edge_key`; `interop/from_flax.state_dict_from_reference`
and `stage2_checkpoint_from_reference` take its trees to the port).

Converts a trained reference Madrigal checkpoint (torch state_dict from
NovelDDIMultilabel / NovelDDIEncoder -- reference: train_ddi_batch.py:
393-412 finetune format, pretrain.py:230-236 CL format, utils.py:246-307
key filtering) into this framework's parameter tree, composing the
component converters in torch_convert.py:

  encoder.str_encoder.*        torchdrug GIN         (exact; verified
                                                      against the released
                                                      GIN_256x4_muv.pt)
  encoder.cv_encoder.*         MLPEncoder            (exact)
  encoder.tx_encoder.*         chemCPA               (exact)
  encoder.transformer.*        TransformerFusion     (exact; pure torch)
  encoder.uni_projector/fuser  MLPAdaptor            (exact)
  encoder.pos_encoder.pe       learnable PE          (exact)
  encoder.cls / tx_bottleneck_tokens                 (exact)
  decoder.parametrizations.weight.original           (exact; our stored
                                                      weight symmetrizes
                                                      identically)
  encoder.kg_encoder.*         PyG HGTConv           (exact for both PyG
                                                      API generations: the
                                                      2.3.x layout+semantics
                                                      via convert_hgt_pyg23
                                                      + softmax_scope=
                                                      'global', the <=2.2
                                                      layout via
                                                      convert_hgt_pyg22 +
                                                      the default per-edge-
                                                      type scope; each is
                                                      parity-tested against
                                                      a key-exact torch
                                                      replica, tests/
                                                      pyg_hgt_replicas.py)

Missing modules (e.g. fusion dropped by the CL->finetune filter) keep
their fresh initialization, mirroring load_state_dict(strict=False).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .torch_convert import (
    _dense,
    _ln,
    _np,
    convert_chemcpa_mlp,
    convert_gin,
    convert_mlp_encoder,
    convert_transformer_fusion,
    filter_prefix,
)


def convert_hgt_pyg23(sd: Dict, node_types, edge_types, num_layers: int,
                      heads: int, hidden: int) -> dict:
    """PyG 2.3.x HGTConv state_dict -> our HGTEncoder params.

    Torch layout per conv i (enforced by the key-exact replica fixture in
    tests/pyg_hgt_replicas.py -- the test fails if these assumptions
    drift):
      convs.{i}.kqv_lin.lins.{nt}.weight [3F, in], .bias [3F]
          (HeteroDictLinear; output thirds are k|q|v in order)
      convs.{i}.out_lin.lins.{nt}.weight [F, F], .bias [F]
      convs.{i}.k_rel.weight [H*R, D, D] (HeteroLinear applied as
          x @ weight[type]; type index = head * num_edge_types +
          edge_type_index, per HGTConv._construct_src_node_feat's
          `type_vec = arange(H).view(-1,1).repeat(1,N) * num_edge_types +
          edge_type_offset`), convs.{i}.v_rel.weight likewise
      convs.{i}.skip.{nt} [1]
      convs.{i}.p_rel.{'__'.join(edge_type)} [1, H]
      lin_dict.{nt}.weight/bias (output head)
    Use with HGTConfig(softmax_scope='global'): the 2.3 rewrite softmaxes
    over all incoming edges of a destination node across edge types.
    Raises KeyError listing what is missing when the layout differs.
    """
    from ..data.kg import edge_key

    R = len(edge_types)
    params: dict = {}
    missing: List[str] = []

    def grab(key):
        if key not in sd:
            missing.append(key)
            return None
        return _np(sd[key])

    for i in range(num_layers):
        layer: dict = {}
        for nt in node_types:
            w = grab(f"convs.{i}.kqv_lin.lins.{nt}.weight")
            b = grab(f"convs.{i}.kqv_lin.lins.{nt}.bias")
            if w is not None:
                layer[f"kqv__{nt}"] = {"kernel": w.T,
                                       "bias": b if b is not None else
                                       np.zeros(w.shape[0], np.float32)}
            w = grab(f"convs.{i}.out_lin.lins.{nt}.weight")
            b = grab(f"convs.{i}.out_lin.lins.{nt}.bias")
            if w is not None:
                layer[f"out__{nt}"] = {"kernel": w.T,
                                       "bias": b if b is not None else
                                       np.zeros(w.shape[0], np.float32)}
            s = grab(f"convs.{i}.skip.{nt}")
            if s is not None:
                layer[f"skip__{nt}"] = s.reshape(1)
        k_rel = grab(f"convs.{i}.k_rel.weight")
        v_rel = grab(f"convs.{i}.v_rel.weight")
        for ei, et in enumerate(edge_types):
            ek = edge_key(tuple(et))
            rows = np.arange(heads) * R + ei  # head-major type indexing
            if k_rel is not None:
                layer[f"k_rel__{ek}"] = k_rel[rows]
            if v_rel is not None:
                layer[f"v_rel__{ek}"] = v_rel[rows]
            p = grab(f"convs.{i}.p_rel.{'__'.join(et)}")
            if p is not None:
                layer[f"p_rel__{ek}"] = p.reshape(-1)
        params[f"conv_{i}"] = layer
    for nt in node_types:
        w = grab(f"lin_dict.{nt}.weight")
        b = grab(f"lin_dict.{nt}.bias")
        if w is not None and nt == "drug":
            params["lin__drug"] = {"kernel": w.T, "bias": b}
    if missing:
        raise KeyError(
            "PyG HGT layout mismatch; missing keys (first 10): "
            f"{missing[:10]} -- adapt convert_hgt_pyg23 to your PyG version"
        )
    return params


def convert_hgt_pyg22(sd: Dict, node_types, edge_types, num_layers: int,
                      heads: int, hidden: int) -> dict:
    """PyG <=2.2 HGTConv state_dict -> our HGTEncoder params.

    The pre-rewrite layout (the API surface the reference's code text
    targets -- it passes group='sum', which only the <=2.2 HGTConv
    accepts). Torch layout per conv i:
      convs.{i}.k_lin.{nt}.weight [F, in], .bias [F] (q_lin/v_lin same)
      convs.{i}.a_lin.{nt}.weight [F, F], .bias [F]
      convs.{i}.skip.{nt} [1]
      convs.{i}.a_rel.{ek} [H, D, D] (k transform; applied k^T @ a_rel)
      convs.{i}.m_rel.{ek} [H, D, D] (v transform)
      convs.{i}.p_rel.{ek} [H]
      lin_dict.{nt}.weight/bias
    Use with HGTConfig(softmax_scope='per_edge_type') (the default).
    """
    from ..data.kg import edge_key

    params: dict = {}
    missing: List[str] = []

    def grab(key):
        if key not in sd:
            missing.append(key)
            return None
        return _np(sd[key])

    for i in range(num_layers):
        layer: dict = {}
        for nt in node_types:
            ws = [grab(f"convs.{i}.{lin}.{nt}.weight")
                  for lin in ("k_lin", "q_lin", "v_lin")]
            bs = [grab(f"convs.{i}.{lin}.{nt}.bias")
                  for lin in ("k_lin", "q_lin", "v_lin")]
            if all(w is not None for w in ws):
                layer[f"kqv__{nt}"] = {
                    "kernel": np.concatenate([w.T for w in ws], axis=1),
                    "bias": np.concatenate([
                        b if b is not None else np.zeros(w.shape[0],
                                                         np.float32)
                        for w, b in zip(ws, bs)
                    ]),
                }
            w = grab(f"convs.{i}.a_lin.{nt}.weight")
            b = grab(f"convs.{i}.a_lin.{nt}.bias")
            if w is not None:
                layer[f"out__{nt}"] = {"kernel": w.T,
                                       "bias": b if b is not None else
                                       np.zeros(w.shape[0], np.float32)}
            s = grab(f"convs.{i}.skip.{nt}")
            if s is not None:
                layer[f"skip__{nt}"] = s.reshape(1)
        for et in edge_types:
            ek = edge_key(tuple(et))
            a = grab(f"convs.{i}.a_rel.{ek}")
            m = grab(f"convs.{i}.m_rel.{ek}")
            p = grab(f"convs.{i}.p_rel.{ek}")
            if a is not None:
                layer[f"k_rel__{ek}"] = a
            if m is not None:
                layer[f"v_rel__{ek}"] = m
            if p is not None:
                layer[f"p_rel__{ek}"] = p.reshape(-1)
        params[f"conv_{i}"] = layer
    for nt in node_types:
        w = grab(f"lin_dict.{nt}.weight")
        b = grab(f"lin_dict.{nt}.bias")
        if w is not None and nt == "drug":
            params["lin__drug"] = {"kernel": w.T, "bias": b}
    if missing:
        raise KeyError(
            "PyG <=2.2 HGT layout mismatch; missing keys (first 10): "
            f"{missing[:10]}"
        )
    return params


def convert_reference_encoder(
    sd: Dict,
    enc_cfg,
    kg_metadata=None,
    strict_kg: bool = False,
) -> Tuple[dict, dict]:
    """NovelDDIEncoder state_dict (prefixes already stripped of
    'base_encoder.' / 'encoder.') -> (params, batch_stats) overlays."""
    params: dict = {}
    stats: dict = {}

    if any(k.startswith("str_encoder.") for k in sd):
        sub = filter_prefix(sd, "str_encoder")
        n_layers = len(tuple(enc_cfg.gin.hidden_dims)) + 1
        p, s = convert_gin(sub, num_layers=n_layers,
                           num_mlp_layer=enc_cfg.gin.num_mlp_layer)
        params["str_encoder"] = p
        if s:
            stats["str_encoder"] = s

    if any(k.startswith("cv_encoder.") for k in sd):
        sub = filter_prefix(sd, "cv_encoder")
        p, s = convert_mlp_encoder(sub, tuple(enc_cfg.cv.hidden_dims),
                                   enc_cfg.cv.dropout, enc_cfg.cv.norm)
        params["cv_encoder"] = p
        if s:
            stats["cv_encoder"] = s

    if any(k.startswith("tx_encoder.") for k in sd):
        from .torch_convert import convert_chemcpa

        sub = filter_prefix(sd, "tx_encoder")
        cov_key = "covariates_embeddings.0.weight"
        if cov_key in sub:
            c = enc_cfg.chemcpa
            p, s = convert_chemcpa(
                sub, sub[cov_key], encoder_depth=c.autoencoder_depth,
                embedding_encoder_depth=c.embedding_encoder_depth,
                dosers_depth=c.dosers_depth, use_drugs=c.use_drugs,
                doser_type=c.doser_type,
                drug_embedding_weight=sub.get("drug_embeddings.weight"),
            )
            params["tx_encoder"] = p
            if s:
                stats["tx_encoder"] = s

    if any(k.startswith("kg_encoder.") for k in sd):
        if kg_metadata is None:
            if strict_kg:
                raise ValueError("kg_metadata required for KG conversion")
        else:
            sub = filter_prefix(sd, "kg_encoder")
            try:
                params["kg_encoder"] = convert_hgt_pyg23(
                    sub, kg_metadata.node_types, kg_metadata.edge_types,
                    enc_cfg.hgt.num_layers, enc_cfg.hgt.att_heads,
                    enc_cfg.hgt.hidden_dim,
                )
                # the 2.3 layout implies the 2.3 attention semantics: a
                # model built with the default per-edge-type scope would
                # load these weights cleanly but normalize attention
                # differently -- refuse the silent mismatch
                scope = getattr(enc_cfg.hgt, "softmax_scope",
                                "per_edge_type")
                if scope != "global":
                    raise ValueError(
                        "checkpoint uses the PyG 2.3 HGT layout, whose "
                        "rewritten HGTConv softmaxes globally across edge "
                        "types; set HGTConfig(softmax_scope='global') on "
                        "the consuming config (got "
                        f"'{scope}')"
                    )
            except KeyError as e23:
                # not the 2.3 layout; try the <=2.2 layout, which matches
                # the default per-edge-type scope
                try:
                    params["kg_encoder"] = convert_hgt_pyg22(
                        sub, kg_metadata.node_types,
                        kg_metadata.edge_types, enc_cfg.hgt.num_layers,
                        enc_cfg.hgt.att_heads, enc_cfg.hgt.hidden_dim,
                    )
                    scope = getattr(enc_cfg.hgt, "softmax_scope",
                                    "per_edge_type")
                    if scope != "per_edge_type":
                        raise ValueError(
                            "checkpoint uses the PyG <=2.2 HGT layout "
                            "(per-edge-type softmax + group); set "
                            "HGTConfig(softmax_scope='per_edge_type') "
                            f"(got '{scope}')"
                        )
                except KeyError:
                    if strict_kg:
                        raise e23

    if any(k.startswith("transformer.") for k in sd):
        sub = filter_prefix(sd, "transformer")
        params["transformer"] = convert_transformer_fusion(
            sub, enc_cfg.transformer.num_layers, enc_cfg.transformer.agg
        )

    for name in ("uni_projector", "uni_fuser"):
        if any(k.startswith(name + ".") for k in sd):
            sub = filter_prefix(sd, name)
            p, s = convert_mlp_encoder(
                sub, tuple(enc_cfg.proj.hidden_dims), enc_cfg.proj.dropout,
                enc_cfg.proj.norm,
            )
            params[name] = p
            if s:
                stats[name] = s

    if "pos_encoder.pe" in sd:
        params["pos_encoder"] = {"pe": _np(sd["pos_encoder.pe"])}
    if "tx_bottleneck_tokens" in sd:
        params["tx_bottleneck_tokens"] = _np(sd["tx_bottleneck_tokens"])
    if "cls" in sd:
        params["cls"] = _np(sd["cls"])

    return params, stats


def convert_reference_finetune_checkpoint(
    state_dict: Dict, enc_cfg, kg_metadata=None, strict_kg: bool = False,
) -> Tuple[dict, dict]:
    """Full NovelDDIMultilabel state_dict -> (params, batch_stats).

    Handles the 'encoder.' prefix and the decoder's parametrized weight
    (decoder.parametrizations.weight.original; reference models.py:922 --
    our stored weight symmetrizes identically at apply time)."""
    enc_sd = filter_prefix(state_dict, "encoder")
    params, stats = convert_reference_encoder(
        enc_sd, enc_cfg, kg_metadata, strict_kg
    )
    out_params = {"encoder": params}
    out_stats = {"encoder": stats} if stats else {}

    for key in ("decoder.parametrizations.weight.original",
                "decoder.weight"):
        if key in state_dict:
            out_params["decoder"] = {"weight": _np(state_dict[key])}
            break
    return out_params, out_stats


def convert_reference_cl_checkpoint(
    state_dict: Dict, enc_cfg, kg_metadata=None,
    use_pretrained_adaptor: bool = False,
) -> Tuple[dict, dict]:
    """CL checkpoint (base_encoder.* keys) with the reference's
    finetune-transfer filter applied (utils.py:281-296): keep encoders,
    drop fusion / pos-enc / CLS / bottlenecks (and optionally the
    adaptor)."""
    sd = filter_prefix(state_dict, "base_encoder")
    drop_prefixes = ["head.", "pos_encoder.", "transformer."]
    drop_exact = {"tx_bottleneck_tokens", "cls"}
    if not use_pretrained_adaptor:
        drop_prefixes.append("uni_projector.")
    kept = {
        k: v for k, v in sd.items()
        if k not in drop_exact
        and not any(k.startswith(p) for p in drop_prefixes)
    }
    return convert_reference_encoder(kept, enc_cfg, kg_metadata)
