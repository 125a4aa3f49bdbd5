"""The port's alternative encoders against the JAX package, float32.

  * GATConv and GATEncoder, HANConv and HANEncoder, and the RGCN, each
    from the same weights (carried by `interop/from_flax.py`, perturbed
    so that a wrong mapping shows), at train=False with dropout 0:
    outputs within atol = rtol = 1e-5 (the same f32 math, summed in
    another order).
  * The whole `MadrigalMultilabel` with each of gat/hgt, gin/han and
    gin/rgcn at `tests/test_alt_encoders.py`'s narrow widths, from the
    port's initial weights carried to flax (`to_flax`): scores within
    1e-5, each JAX model applied once for the module.
  * Three trainer steps of the gat/hgt model against the JAX trainer
    (`assert_three_steps_match_jax`, with its tolerances).
  * GAT's attention weights sum to 1 over each destination's incoming
    edges, as `tests/test_alt_encoders.py` checks the JAX ones.
  * The training CLI takes each encoder choice and the bf16 mode through
    --set, and the serving CLI serves the checkpoint it writes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.models import encoder as j_enc
from madrigal_tpu.models import gat as j_gat
from madrigal_tpu.models import kg_alt as j_kg_alt
from madrigal_tpu.train import finetune as j_ft
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.interop.from_flax import load_flax_weights
from madrigal_tpu_torch.models import gat as t_gat
from madrigal_tpu_torch.models import kg_alt as t_kg_alt
from madrigal_tpu_torch.models.encoder import (
    MadrigalMultilabel,
    init_weights,
    kg_schema_from_state_dict,
)
from madrigal_tpu_torch.ops import gather as t_gather
from madrigal_tpu_torch.ops.segment import segment_softmax, segment_sum
from madrigal_tpu_torch.ops.segment_sorted import sorted_segment_sum
from madrigal_tpu_torch.train import finetune as t_ft
from tests.test_torch_models import carried, close
from tests.test_torch_stage1 import to_flax
from tests.test_torch_train import (
    DATA,
    assert_three_steps_match_jax,
    one_thread,  # noqa: F401  (fixture)
    tiny_cfg,
)

DATASET = dict(num_drugs=14, num_labels=4, num_edges=24, seed=8)


def applied(j_module, v, *args, **kw):
    """`j_module.apply(v, *args, **kw)` as one compiled program (float32:
    within 1e-6 of op-by-op dispatch), for a module applied once."""
    return jax.jit(lambda v_, *a: j_module.apply(v_, *a, **kw))(v, *args)


def alt_cfg(c, str_enc="gin", kg_enc="hgt"):
    """`tests/test_alt_encoders.py`'s narrow widths, dropout 0."""
    return c.EncoderConfig(
        feature_dim=16, str_encoder=str_enc,
        gin=c.GINConfig(hidden_dims=(16, 16), num_mlp_layer=2),
        gat=c.GATConfig(hidden_dims=(16, 16), att_heads=2),
        kg_encoder=kg_enc,
        hgt=c.HGTConfig(hidden_dim=8, num_layers=2, att_heads=2),
        han=c.HANConfig(hidden_dim=8, num_layers=1, att_heads=2,
                        dropout=0.0),
        rgcn=c.RGCNConfig(hidden_dim=8, num_layers=2, num_bases=4),
        cv=c.MLPEncoderConfig(hidden_dims=(32, 16), dropout=0.0),
        chemcpa=c.ChemCPAConfig(dim=16, autoencoder_width=32,
                                autoencoder_depth=1),
        transformer=c.FusionConfig(num_layers=1, att_heads=2, head_dim=8,
                                   ffn_dim=32, dropout=0.0, norm_first=True,
                                   agg="x-attn", num_tx_bottlenecks=2),
        proj=c.ProjectorConfig(hidden_dims=(32, 32), dropout=0.0),
        pos_emb_type="sinusoidal", pos_emb_dropout=0.0)


@pytest.fixture(scope="module")
def data():
    dj, dt = j_syn.make_dataset(**DATASET), t_syn.make_dataset(**DATASET)
    bj, kj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0,
                                   kg_src_sort=False)()
    bt, kt = t_collate.DDICollator(dt, split="train", device="cpu")()
    return dt, bj, kj, bt, kt


# ----------------------------------------------------------------- GAT
@pytest.mark.parametrize("batch_norm,actn", [(False, "relu"),
                                             (True, "gelu")])
def test_gat_conv(data, batch_norm, actn):
    _, bj, _, bt, _ = data
    gj, gt = bj.head.mols, bt.head.mols
    x = gj.node_feats
    kw = dict(num_head=2, negative_slope=0.3, batch_norm=batch_norm,
              actn=actn)
    jm = j_gat.GATConv(output_dim=12, **kw)
    tm = t_gat.GATConv(x.shape[1], 12, edge_input_dim=gt.edge_feats.shape[1],
                       **kw)
    v, tm = carried(jm, tm, gj, x, train=False)
    with torch.no_grad():
        close(tm(gt, gt.node_feats), jm.apply(v, gj, x, train=False))


@pytest.mark.parametrize("readout", ["mean", "sum"])
def test_gat_encoder(data, readout):
    _, bj, _, bt, _ = data
    gj, gt = bj.tail.mols, bt.tail.mols
    kw = dict(num_head=2, batch_norm=True, readout=readout)
    jm = j_gat.GATEncoder(hidden_dims=(16, 16, 8), **kw)
    tm = t_gat.GATEncoder(hidden_dims=(16, 16, 8), **kw)
    v, tm = carried(jm, tm, gj, train=False)
    with torch.no_grad():
        t_graph, t_node = tm(gt)
    j_graph, j_node = jm.apply(v, gj, train=False)
    close(t_graph, j_graph)
    close(t_node, j_node)


def test_gat_attention_normalizes(data):
    """Per-destination attention weights sum to 1 over the incoming
    edges; destinations without edges get none."""
    _, _, _, bt, _ = data
    g = bt.head.mols
    logits = torch.from_numpy(np.random.RandomState(0).randn(
        g.edge_src.shape[0], 2).astype(np.float32))
    n = g.num_nodes_padded
    dst = torch.where(g.edge_mask, g.edge_dst.long(),
                      torch.full_like(g.edge_dst.long(), n))
    sums = segment_sum(segment_softmax(logits, dst, n, mask=g.edge_mask),
                       dst, n)
    has_in = segment_sum(g.edge_mask.float(), dst, n) > 0
    np.testing.assert_allclose(sums[has_in].numpy(), 1.0, atol=1e-5)
    np.testing.assert_array_equal(sums[~has_in].numpy(), 0.0)
    assert has_in.any() and (~has_in).any()


# ------------------------------------------------------------ HAN, RGCN
@pytest.mark.parametrize("unreached", [None, "disease"])
def test_han_conv(data, unreached):
    """Over the whole KG, and over one without the edge types into
    `unreached`, whose nodes then get zeros."""
    from madrigal_tpu.data.kg import build_kg_batch as j_build
    from madrigal_tpu_torch.data.kg import build_kg_batch as t_build

    dt = data[0]
    edges = {et: ei for et, ei in dt.kg_edge_indices.items()
             if et[2] != unreached}
    kj = j_build(dt.kg_node_feats, edges, dt.kg_drug_ids)
    kt = t_build(dt.kg_node_feats, edges, dt.kg_drug_ids, device="cpu")
    dims, edge_types = kg_schema(dt.kg_node_feats, edges)
    jm = j_kg_alt.HANConv(out_channels=8, heads=2, negative_slope=0.25)
    tm = t_kg_alt.HANConv(dims, edge_types, 8, heads=2,
                          negative_slope=0.25)
    v, tm = carried(jm, tm, kj, dict(kj.node_feats), train=False)
    with torch.no_grad():
        t_out = tm(kt, dict(kt.node_feats))
    j_out = jm.apply(v, kj, dict(kj.node_feats), train=False)
    assert set(t_out) == set(j_out) == set(dims)
    for nt in j_out:
        close(t_out[nt], j_out[nt])
    if unreached:
        assert not t_out[unreached].any()


@pytest.mark.parametrize("num_layers", [1, 3])
def test_han_encoder(data, num_layers):
    """Three layers put the relu after conv 1 only (reference HAN)."""
    dt, _, kj, _, kt = data
    cfg = dict(hidden_dim=8, num_layers=num_layers, att_heads=2,
               dropout=0.3)
    jm = j_kg_alt.HANEncoder(cfg=j_config.HANConfig(**cfg), embed_dim=6)
    tm = t_kg_alt.HANEncoder(t_config.HANConfig(**cfg), 6,
                             *kg_schema(dt.kg_node_feats,
                                        dt.kg_edge_indices))
    v, tm = carried(jm, tm, kj, train=False)
    with torch.no_grad():
        close(tm(kt)["drug"], jm.apply(v, kj, train=False)["drug"])


@pytest.mark.parametrize("aggr,actn", [("mean", "relu"), ("sum", "gelu")])
def test_rgcn_encoder(data, aggr, actn):
    dt, _, kj, _, kt = data
    kw = dict(num_layers=2, num_bases=3, aggr=aggr, actn=actn)
    jm = j_kg_alt.RGCNEncoder(hidden_dim=8, embed_dim=6, **kw)
    widths = {f.shape[1] for f in dt.kg_node_feats.values()}
    tm = t_kg_alt.RGCNEncoder(widths.pop(), len(dt.kg_edge_indices), 8, 6,
                              **kw)
    v, tm = carried(jm, tm, kj, train=False)
    with torch.no_grad():
        close(tm(kt)["drug"], jm.apply(v, kj, train=False)["drug"])


# -------------------------------------------------------- whole model
def port_model(cfg, schema, seed: int, prediction_dim: int = 4):
    """A port MadrigalMultilabel in eval mode with init_weights' weights
    from `seed` and random BatchNorm statistics, and the same variables as
    a flax tree (`tests/test_torch_stage1.to_flax`): building the JAX
    model's variables this way costs no XLA compile of its init."""
    model = MadrigalMultilabel(cfg, prediction_dim, *schema)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.3, generator=gen)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=gen)
    params, stats = to_flax(model)
    return model.eval(), {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def whole_models(data):
    """Per configuration: the port's model and the JAX model's scores
    from the same variables, applied op by op (the ops' compiles are
    shared across the configurations and with the other tests)."""
    dt, bj, kj, _, _ = data
    schema = kg_schema(dt.kg_node_feats, dt.kg_edge_indices)
    out = {}
    for str_enc, kg_enc in (("gat", "hgt"), ("gin", "han"),
                            ("gin", "rgcn")):
        model, v = port_model(alt_cfg(t_config, str_enc, kg_enc), schema,
                              seed=0)
        jm = j_enc.MadrigalMultilabel(enc_cfg=alt_cfg(j_config, str_enc,
                                                      kg_enc),
                                      prediction_dim=4)
        out[str_enc, kg_enc] = (model, np.asarray(
            jm.apply(v, bj.head, bj.tail, kj, train=False)))
    return out


@pytest.mark.parametrize("str_enc,kg_enc", [
    ("gat", "hgt"), ("gin", "han"), ("gin", "rgcn")])
def test_whole_model_scores(data, whole_models, str_enc, kg_enc):
    _, _, _, bt, kt = data
    model, want = whole_models[str_enc, kg_enc]
    with torch.no_grad():
        got = model(bt.head, bt.tail, kt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the schema read back from the state_dict rebuilds the same model
    rebuilt = MadrigalMultilabel(alt_cfg(t_config, str_enc, kg_enc), 4,
                                 *kg_schema_from_state_dict(
                                     model.state_dict()))
    rebuilt.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        assert torch.equal(rebuilt.eval()(bt.head, bt.tail, kt), got)


@pytest.mark.parametrize("kg_enc,cls", [
    ("hgt_drug_edge_only", "HGTEncoder"), ("han_metapath", "HANEncoder"),
    ("rgcn_bases", "RGCNEncoder")])
def test_kg_encoder_chosen_as_jax_chooses(data, kg_enc, cls):
    """'han' and 'rgcn' are matched as substrings, as the JAX package
    matches them (madrigal_tpu/models/encoder.py:79-97)."""
    dt = data[0]
    model = MadrigalMultilabel(alt_cfg(t_config, "gat", kg_enc), 4,
                               *kg_schema(dt.kg_node_feats,
                                          dt.kg_edge_indices))
    assert type(model.encoder.kg_encoder).__name__ == cls
    assert type(model.encoder.str_encoder).__name__ == "GATEncoder"


@pytest.mark.parametrize("field,value", [
    ("str_encoder", "gcn"), ("kg_encoder", "gnn")])
def test_unknown_encoders_raise(data, field, value):
    dt = data[0]
    cfg = dataclasses.replace(alt_cfg(t_config), **{field: value})
    with pytest.raises(NotImplementedError, match=value):
        MadrigalMultilabel(cfg, 4, *kg_schema(dt.kg_node_feats,
                                              dt.kg_edge_indices))


def test_gat_hgt_trainer_three_steps_match_jax(monkeypatch):
    """The gat/hgt model trains 3 steps as the JAX trainer does, its HGT
    backward on K2's plain version (CPU), launched once a step for each
    (layer, edge type) that reaches the drug table."""
    calls = []

    def counted(*args):
        calls.append((args[0].dtype, args[0].shape[1]))
        return sorted_segment_sum(*args)

    monkeypatch.setattr(t_gather, "sorted_segment_sum", counted)
    dj, dt = j_syn.make_dataset(**DATA), t_syn.make_dataset(**DATA)
    bj, kj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0,
                                   kg_src_sort=True)()
    bt, kt = t_collate.DDICollator(dt, split="train", device="cpu",
                                   kg_src_sort=True)()

    def gat_cfg(c):
        cfg = tiny_cfg(c, "full_full")
        enc = dataclasses.replace(
            cfg.model.encoder, str_encoder="gat",
            gat=c.GATConfig(hidden_dims=(16, 16), att_heads=2))
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, encoder=enc))

    jt = j_ft.FinetuneTrainer(gat_cfg(j_config), bj, kj)
    cfg = gat_cfg(t_config)
    model = MadrigalMultilabel(cfg.model.encoder, 6,
                               *kg_schema(dt.kg_node_feats,
                                          dt.kg_edge_indices))
    load_flax_weights(model, {"params": jt.state.params,
                              "batch_stats": jt.state.batch_stats})
    assert_three_steps_match_jax(jt, t_ft.FinetuneTrainer(cfg, bt, kt,
                                                          model))
    # every gather transpose reduces f32 rows; the fused k|v table's
    # (2 x 64 wide) once per step and (layer, edge type) reaching drugs
    assert {dt for dt, _ in calls} == {torch.float32}
    assert [w for _, w in calls].count(128) == 3 * (2 + 7)


@pytest.mark.parametrize("extra", [
    ["--set", "model.encoder.str_encoder=gat",
     "--set", "model.encoder.kg_encoder=rgcn"],
    ["--set", "model.encoder.kg_encoder=han"],
    ["--set", "model.encoder.hgt.compute_dtype=bfloat16",
     "--set", "model.encoder.transformer.compute_dtype=bfloat16"]])
def test_cli_trains_and_serves(tmp_path, extra):
    """The training CLI takes each encoder choice and the bf16 mode
    through --set; the serving CLI rebuilds the model from the checkpoint
    alone (its KG schema read back from the state_dict) and exports the
    scores of the model it holds."""
    from madrigal_tpu_torch.cli import predict as t_predict
    from madrigal_tpu_torch.cli import train_ddi as t_cli
    from madrigal_tpu_torch.eval.predict import (
        embed_all_drugs,
        model_from_checkpoint,
        score_all_pairs,
    )
    from tests.test_torch_train import CLI

    res = t_cli.main(CLI + ["--num_epochs", "1", "--save_dir",
                            str(tmp_path)] + extra)
    assert np.isfinite(res["losses"][0]["total"])
    model, cfg = model_from_checkpoint(res["checkpoint"], device="cpu")
    for kv in extra[1::2]:
        key, value = kv.split("=")
        obj = cfg
        for part in key.split(".")[:-1]:
            obj = getattr(obj, part)
        assert getattr(obj, key.split(".")[-1]) == value
    scores = tmp_path / "s.npy"
    data = ["--synthetic", "--synthetic_drugs", "14", "--synthetic_labels",
            "4", "--synthetic_edges", "20", "--seed", "3"]
    t_predict.main(["--checkpoint", res["checkpoint"], "--platform", "cpu",
                    "--label_chunk", "3", "--export_scores", str(scores)]
                   + data)
    ds = t_syn.make_dataset(num_drugs=14, num_labels=4, num_edges=20, seed=3)
    coll = t_collate.DDICollator(ds, split="train", device="cpu")
    with torch.no_grad():
        z = embed_all_drugs(model, coll, coll.kg_batch())
    np.testing.assert_allclose(np.load(scores), score_all_pairs(model, z),
                               atol=1e-5, rtol=1e-5)
