"""Each model module of the port against its JAX module, at train=False,
with the same weights carried across by `interop/from_flax.py`.

The flax parameters are initialised, then perturbed with numpy noise so
that gates initialised to one (HGT p_rel and skip, GIN eps, norm scales)
and BatchNorm running statistics take values that a wrong mapping would
show. Tolerance atol = rtol = 1e-5 (the same f32 math, summed in another
order); the HGT takes 1e-4 because its segment softmax normalises sums of
exponentials taken in another order over each destination's edges.
"""
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrigal_tpu.config import (
    ChemCPAConfig as JChemCPAConfig,
    FusionConfig as JFusionConfig,
    HGTConfig as JHGTConfig,
)
from madrigal_tpu.constants import NUM_CELL_LINES, NUM_MODALITIES, NUM_NON_TX_MODALITIES
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.models import attention as j_attn
from madrigal_tpu.models import chemcpa as j_chemcpa
from madrigal_tpu.models import decoder as j_dec
from madrigal_tpu.models import fusion as j_fusion
from madrigal_tpu.models import gin as j_gin
from madrigal_tpu.models import hgt as j_hgt
from madrigal_tpu.models import mlp as j_mlp
from madrigal_tpu.models import norm as j_norm
from madrigal_tpu_torch.config import (
    ChemCPAConfig,
    FusionConfig,
    HGTConfig,
)
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.interop.from_flax import load_flax_weights
from madrigal_tpu_torch.models import attention as t_attn
from madrigal_tpu_torch.models import chemcpa as t_chemcpa
from madrigal_tpu_torch.models import decoder as t_dec
from madrigal_tpu_torch.models import fusion as t_fusion
from madrigal_tpu_torch.models import gin as t_gin
from madrigal_tpu_torch.models import hgt as t_hgt
from madrigal_tpu_torch.models import mlp as t_mlp
from madrigal_tpu_torch.models import norm as t_norm

TOL = dict(atol=1e-5, rtol=1e-5)


def _perturb(tree, rng, collection=None):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _perturb(v, rng, collection or k)
            continue
        a = np.asarray(v, np.float32)
        if collection == "batch_stats" and k == "var":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif collection == "batch_stats":
            a = 0.3 * rng.standard_normal(a.shape)
        else:
            a = a + 0.1 * rng.standard_normal(a.shape)
        out[k] = a.astype(np.float32)
    return out


def carried(j_module, t_module, *init_args, seed=0, **init_kw):
    """Flax variables for `j_module` (perturbed) and `t_module` in eval
    mode holding the same weights."""
    v = j_module.init(jax.random.PRNGKey(seed), *init_args, **init_kw)
    v = _perturb(v, np.random.RandomState(seed))
    load_flax_weights(t_module, v)
    return v, t_module.eval()


def close(t_out, j_out, **tol):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               **(tol or TOL))


def test_masked_batchnorm_eval():
    x = np.random.RandomState(1).randn(9, 6).astype(np.float32)
    mask = np.arange(9) < 6
    jm = j_norm.MaskedBatchNorm()
    v, tm = carried(jm, t_norm.MaskedBatchNorm(6), x, mask, train=False)
    with torch.no_grad():
        close(tm(torch.from_numpy(x), torch.from_numpy(mask)),
              jm.apply(v, x, mask, train=False))


@pytest.mark.parametrize("norm,order,actn", [
    (None, "nd", "relu"), ("bn", "nd", "gelu"), ("ln", "dn", "gelu"),
    ("bn", "dn", "relu")])
def test_mlp_encoder(norm, order, actn):
    x = np.random.RandomState(2).randn(7, 11).astype(np.float32)
    kw = dict(dropout=0.3, norm=norm, actn=actn, order=order)
    jm = j_mlp.MLPEncoder(hidden_dims=(16, 12, 10), output_dim=5, **kw)
    tm = t_mlp.MLPEncoder(11, (16, 12, 10), 5, **kw)
    v, tm = carried(jm, tm, x, train=False)
    with torch.no_grad():
        close(tm(torch.from_numpy(x)), jm.apply(v, x, train=False))


@pytest.mark.parametrize("last", ["linear", "ReLU"])
def test_chemcpa_mlp(last):
    x = np.random.RandomState(3).randn(7, 11).astype(np.float32)
    sizes = [11, 16, 16, 8]
    jm = j_mlp.ChemCPAMLP(sizes=sizes, last_layer_act=last)
    v, tm = carried(jm, t_mlp.ChemCPAMLP(sizes, last_layer_act=last), x,
                    train=False)
    with torch.no_grad():
        close(tm(torch.from_numpy(x)), jm.apply(v, x, train=False))


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_drugs=14, num_labels=4, num_edges=24, seed=11)
    dj, dt = j_syn.make_dataset(**kw), t_syn.make_dataset(**kw)
    cj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0,
                               kg_src_sort=False)
    ct = t_collate.DDICollator(dt, split="train", device="cpu")
    return dj, dt, cj, ct


@pytest.mark.parametrize("learn_eps", [True, False])
def test_gin_encoder(datasets, learn_eps):
    _, _, cj, ct = datasets
    ids = np.arange(14)
    gj, gt = cj.drug_batch(ids).mols, ct.drug_batch(ids).mols
    kw = dict(num_mlp_layer=2, eps_init=0.1, learn_eps=learn_eps)
    jm = j_gin.GINEncoder(hidden_dims=(16, 16, 8), **kw)
    tm = t_gin.GINEncoder(hidden_dims=(16, 16, 8), **kw)
    v, tm = carried(jm, tm, gj, train=False)
    with torch.no_grad():
        t_graph, t_node = tm(gt)
    j_graph, j_node = jm.apply(v, gj, train=False)
    close(t_graph, j_graph)
    close(t_node, j_node)


@pytest.mark.parametrize("use_drugs,doser,basal", [
    (False, "amortized", False), (False, "amortized", True),
    (True, "amortized", False), (True, "sigm", False),
    (True, "logsigm", False)])
def test_chemcpa_encoder(use_drugs, doser, basal):
    kw = dict(num_genes=20, dim=8, autoencoder_width=16, autoencoder_depth=2,
              embedding_encoder_width=12, embedding_encoder_depth=2,
              dosers_width=8, dosers_depth=2, doser_type=doser,
              use_drugs=use_drugs, num_drugs=6, drug_embedding_dim=10,
              num_covariates=3)
    rng = np.random.RandomState(4)
    genes = rng.randn(9, 20).astype(np.float32)
    cov = rng.randint(0, 3, 9).astype(np.int32)
    drugs = rng.randint(0, 6, 9).astype(np.int32)
    dose = rng.uniform(0.1, 2.0, 9).astype(np.float32)
    jm = j_chemcpa.ChemCPAEncoder(cfg=JChemCPAConfig(**kw))
    tm = t_chemcpa.ChemCPAEncoder(ChemCPAConfig(**kw))
    v, tm = carried(jm, tm, genes, cov, drugs, dose, train=False)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (genes, cov, drugs, dose)),
                 return_basal=basal)
    close(got, jm.apply(v, genes, cov, drugs, dose, train=False,
                        return_basal=basal))


@pytest.mark.parametrize("scope,group", [
    ("per_edge_type", "sum"), ("per_edge_type", "mean"),
    ("per_edge_type", "max"), ("global", "sum")])
def test_hgt_encoder(datasets, scope, group):
    dj, _, cj, ct = datasets
    kj, kt = cj.kg_batch(), ct.kg_batch()
    kw = dict(hidden_dim=24, num_layers=3, att_heads=4, group=group,
              softmax_scope=scope)
    jm = j_hgt.HGTEncoder(cfg=JHGTConfig(**kw), embed_dim=8)
    tm = t_hgt.HGTEncoder(HGTConfig(**kw), 8,
                          *kg_schema(dj.kg_node_feats, dj.kg_edge_indices))
    v, tm = carried(jm, tm, kj, train=False)
    assert any(k.startswith("skip__") for k in v["params"]["conv_0"])
    with torch.no_grad():
        t_out = tm(kt)
    j_out = jm.apply(v, kj, train=False)
    assert set(t_out) == set(j_out)
    for nt in j_out:
        close(t_out[nt], j_out[nt], atol=1e-4, rtol=1e-4)


def _attention_inputs(B=4, T=6, E=16):
    rng = np.random.RandomState(5)
    x = rng.randn(B, T, E).astype(np.float32)
    kpm = rng.rand(B, T) < 0.3
    kpm[1] = True  # a fully masked row
    kpm[0] = False
    attn_mask = np.zeros((T, T), bool)
    attn_mask[:2, -2:] = True
    return x, kpm, attn_mask


def test_multihead_attention():
    x, kpm, am = _attention_inputs()
    jm = j_attn.MultiheadAttention(embed_dim=16, num_heads=4)
    v, tm = carried(jm, t_attn.MultiheadAttention(16, 4), x, x, x, kpm, am)
    with torch.no_grad():
        out, w = tm(*(torch.from_numpy(a) for a in (x, x, x, kpm, am)),
                    return_weights=True)
    j_out, j_w = jm.apply(v, x, x, x, kpm, am, return_weights=True)
    close(out, j_out)
    close(w, j_w)


@pytest.mark.parametrize("norm_first", [False, True])
def test_transformer_encoder(norm_first):
    x, kpm, am = _attention_inputs()
    kw = dict(dropout=0.2, actn="gelu", norm_first=norm_first)
    jm = j_attn.TransformerEncoder(num_layers=2, d_model=16, nhead=4,
                                   dim_feedforward=24, **kw)
    tm = t_attn.TransformerEncoder(2, 16, 4, 24, **kw)
    v, tm = carried(jm, tm, x, kpm, am)
    with torch.no_grad():
        out, w = tm(*(torch.from_numpy(a) for a in (x, kpm, am)),
                    return_last_attn=True)
    j_out, j_w = jm.apply(v, x, kpm, am, return_last_attn=True)
    close(out, j_out)
    close(w, j_w)


@pytest.mark.parametrize("agg,num_bt,norm_first", [
    ("x-attn", 2, True), ("x-attn", 0, False), ("cls", 0, True),
    ("mean", 0, False), ("max", 0, True)])
def test_transformer_fusion(agg, num_bt, norm_first):
    kw = dict(num_layers=2, att_heads=2, head_dim=8, ffn_dim=24,
              dropout=0.2, norm_first=norm_first, agg=agg,
              num_tx_bottlenecks=num_bt)
    S = NUM_MODALITIES + num_bt + (agg == "cls")
    rng = np.random.RandomState(6)
    seq = rng.randn(5, S, 12).astype(np.float32)
    fmask = rng.rand(5, S) < 0.4
    fmask[:, NUM_NON_TX_MODALITIES:NUM_NON_TX_MODALITIES + num_bt] = False
    fmask[2, :] = agg == "max"  # max pool: a row that keeps nothing
    src = (j_fusion.build_bottleneck_masks(NUM_NON_TX_MODALITIES, num_bt,
                                           NUM_CELL_LINES, False)
           if num_bt else None)
    num_kv = NUM_MODALITIES + num_bt
    jm = j_fusion.TransformerFusion(cfg=JFusionConfig(**kw), embed_dim=12,
                                    num_kv_tokens=num_kv,
                                    num_non_tx=NUM_NON_TX_MODALITIES)
    tm = t_fusion.TransformerFusion(FusionConfig(**kw), 12, num_kv,
                                    NUM_NON_TX_MODALITIES)
    v, tm = carried(jm, tm, seq, fmask, src)
    with torch.no_grad():
        got = tm(torch.from_numpy(seq), torch.from_numpy(fmask),
                 None if src is None else torch.from_numpy(src))
    close(got, jm.apply(v, seq, fmask, src))


@pytest.mark.parametrize("pe_type", ["learnable", "sinusoidal"])
def test_position_encoding(pe_type):
    x = np.random.RandomState(7).randn(3, 8, 12).astype(np.float32)
    jm = j_fusion.PositionEncoding(max_len=5, d_model=12, pe_type=pe_type,
                                   dropout=0.2)
    tm = t_fusion.PositionEncoding(5, 12, pe_type, dropout=0.2)
    v, tm = carried(jm, tm, x)
    with torch.no_grad():
        close(tm(torch.from_numpy(x)), jm.apply(v, x))


@pytest.mark.parametrize("with_cls", [False, True])
def test_bottleneck_masks(with_cls):
    np.testing.assert_array_equal(
        t_fusion.build_bottleneck_masks(3, 2, 16, with_cls),
        j_fusion.build_bottleneck_masks(3, 2, 16, with_cls))


def test_decoder(monkeypatch):
    L, D, T = 5, 8, 50
    rng = np.random.RandomState(8)
    zh = rng.randn(9, D).astype(np.float32)
    zt = rng.randn(11, D).astype(np.float32)
    a = rng.randn(T, D).astype(np.float32)
    b = rng.randn(T, D).astype(np.float32)
    lb = rng.randint(0, L, T).astype(np.int32)
    jm = j_dec.BilinearDDIScorer(num_labels=L, input_dim1=D, input_dim2=D)
    v, tm = carried(jm, t_dec.BilinearDDIScorer(L, D, D), zh, zt)
    w = v["params"]["weight"]
    np.testing.assert_array_equal(
        t_dec.symmetrize(torch.from_numpy(w)).numpy(),
        np.asarray(j_dec.symmetrize(jnp.asarray(w))))
    monkeypatch.setattr(t_dec.BilinearDDIScorer, "TRIPLE_CHUNK", 16)
    with torch.no_grad():
        close(tm.all_pairs(torch.from_numpy(zh), torch.from_numpy(zt)),
              jm.apply(v, zh, zt, method=j_dec.BilinearDDIScorer.all_pairs))
        close(tm.all_pairs(torch.from_numpy(zh), torch.from_numpy(zt),
                           label_range=(1, 4)),
              jm.apply(v, zh, zt, (1, 4),
                       method=j_dec.BilinearDDIScorer.all_pairs))
        close(tm.triples(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(lb)),
              jm.apply(v, a, b, lb, method=j_dec.BilinearDDIScorer.triples))
