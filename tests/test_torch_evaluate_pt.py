"""Stage-2 evaluation in the port against the JAX package.

  * `encode_single_modality` with the same encoder weights (carried with
    `interop/from_flax`) gives the JAX embeddings within 1e-5, and the
    same valid drugs.
  * `evaluate_pt`, `save_embeds` and `evaluate_final_embeds` on the same
    embeddings (an encoder stand-in that returns a fixed vector per drug
    and modality, in both packages) give the JAX metrics, tables and
    files: the same keys, the same drugs, and values equal to 1e-12 (the
    same numpy code).
  * The `cl_metrics` and `geomca` copies give the originals' outputs,
    exactly.
"""
import json

import jax
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.data.collate import DDICollator as JCollator
from madrigal_tpu.data.synthetic import make_dataset as j_make_dataset
from madrigal_tpu.eval import cl_metrics as j_clm
from madrigal_tpu.eval import evaluate_pt as j_ept
from madrigal_tpu.eval import geomca as j_geo
from madrigal_tpu.models.encoder import MadrigalEncoder as JEncoder
from madrigal_tpu.models.encoder import init_encoder
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.data.collate import DDICollator as TCollator
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.data.synthetic import make_dataset as t_make_dataset
from madrigal_tpu_torch.eval import cl_metrics as t_clm
from madrigal_tpu_torch.eval import evaluate_pt as t_ept
from madrigal_tpu_torch.eval import geomca as t_geo
from madrigal_tpu_torch.interop.from_flax import load_flax_weights
from madrigal_tpu_torch.models.encoder import MadrigalEncoder as TEncoder
from test_torch_train import one_thread  # noqa: F401  (fixture)

DATA = dict(num_drugs=20, num_labels=4, num_edges=20, seed=40)
MODS = (0, 1, 2, 13)


def enc_cfg(c):
    """tests/test_evaluate_pt.py's encoder."""
    return c.EncoderConfig(
        feature_dim=16,
        gin=c.GINConfig(hidden_dims=(16, 16), num_mlp_layer=2),
        hgt=c.HGTConfig(hidden_dim=8, num_layers=2, att_heads=2),
        cv=c.MLPEncoderConfig(hidden_dims=(32, 16)),
        chemcpa=c.ChemCPAConfig(dim=16, autoencoder_width=32,
                                autoencoder_depth=1),
        transformer=c.FusionConfig(num_layers=1, att_heads=2, head_dim=8,
                                   ffn_dim=32, dropout=0.0, norm_first=True,
                                   agg="x-attn", num_tx_bottlenecks=2),
        proj=c.ProjectorConfig(hidden_dims=(32, 32)),
        pos_emb_type="sinusoidal",
    )


@pytest.fixture(scope="module")
def setup():
    dj, dt = j_make_dataset(**DATA), t_make_dataset(**DATA)
    cj = JCollator(dj, split="train")
    ct = TCollator(dt, split="train", device="cpu")
    return dt, cj, cj.kg_batch(), ct, ct.kg_batch()


# ------------------------------------------------- the encoder, carried
def test_encode_single_modality_matches_jax(setup):
    dt, cj, kj, ct, kt = setup
    jenc = JEncoder(cfg=enc_cfg(j_config))
    variables = init_encoder(jenc, jax.random.PRNGKey(0),
                             cj.drug_batch(np.arange(8)), kj)

    def apply_fn(vs, batch, kg, raw):
        return jenc.apply(
            vs, batch, kg, train=False, raw_encoder_output=raw,
            method=lambda m, b, k, train, raw_encoder_output: m.encode(
                b, kg=k, train=train, raw_encoder_output=raw_encoder_output))

    tenc = TEncoder(enc_cfg(t_config),
                    *kg_schema(dt.kg_node_feats, dt.kg_edge_indices))
    load_flax_weights(tenc, variables)
    drugs = np.arange(DATA["num_drugs"])
    for mi, raw in ((0, True), (1, False), (2, True)):
        zj, vj = j_ept.encode_single_modality(apply_fn, variables, cj, kj,
                                              drugs, mi, raw)
        zt, vt = t_ept.encode_single_modality(tenc, ct, kt, drugs, mi, raw,
                                              batch_size=7)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_allclose(zt, zj, atol=1e-5, rtol=1e-5)


# --------------------------------------------- the same embeddings
class FixedEmbeddings:
    """One fixed vector per (drug, modality): the embedding of a batch
    whose masks keep only that modality."""

    def __init__(self, num_drugs, num_modalities, dim=8, seed=0):
        self.table = np.random.RandomState(seed).randn(
            num_drugs, num_modalities, dim).astype(np.float32)

    def lookup(self, drugs, masks):
        drugs, masks = np.asarray(drugs), np.asarray(masks)
        return self.table[drugs, np.argmin(masks, axis=1)]

    # the JAX package's apply-function form
    def jax_apply(self, variables, batch, kg, raw):
        return self.lookup(batch.drugs, batch.masks)

    # the port's encoder form
    def eval(self):
        return self

    def kg_drug_table(self, kg):
        return None

    def encode(self, batch, kg=None, kg_drug_table=None,
               raw_encoder_output=False):
        return torch.from_numpy(self.lookup(batch.drugs.numpy(),
                                            batch.masks.numpy()))


@pytest.fixture(scope="module")
def fixed(setup):
    dt = setup[0]
    return FixedEmbeddings(dt.num_drugs, np.asarray(dt.masks).shape[1])


def assert_same_tree(got, want, path=""):
    assert type(got) is type(want) or np.isscalar(got), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   err_msg=path)


def test_evaluate_pt_matches_jax(setup, fixed):
    _, cj, kj, ct, kt = setup
    drugs = np.arange(DATA["num_drugs"])
    want = j_ept.evaluate_pt(fixed.jax_apply, None, cj, kj, drugs,
                             modality_indices=MODS, topk=(1, 5))
    got = t_ept.evaluate_pt(fixed, ct, kt, drugs, modality_indices=MODS,
                            topk=(1, 5))
    assert any(k.startswith("top1_0_") for k in want)
    assert_same_tree(got, want)


def test_save_embeds_and_final_table_match_jax(setup, fixed, tmp_path):
    _, cj, kj, ct, kt = setup
    kw = dict(train_drugs=np.arange(14), val_drugs=np.arange(14, 20),
              modality_indices=MODS)
    want = j_ept.save_embeds(fixed.jax_apply, None, cj, kj,
                             save_dir=str(tmp_path / "jax"), **kw)
    got = t_ept.save_embeds(fixed, ct, kt, save_dir=str(tmp_path / "port"),
                            **kw)
    assert_same_tree(got, want)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files
    for name in files:
        a, b = np.load(tmp_path / "jax" / name), np.load(tmp_path / "port"
                                                         / name)
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=name)

    tj = j_ept.evaluate_final_embeds(want, save_dir=str(tmp_path / "jax"))
    tt = t_ept.evaluate_final_embeds(got, save_dir=str(tmp_path / "port"))
    assert any(k.startswith("train 0 v ") for k in tj)
    assert_same_tree(tt, tj)
    with open(tmp_path / "jax" / "final_embeds_metrics.json") as f:
        jj = json.load(f)
    with open(tmp_path / "port" / "final_embeds_metrics.json") as f:
        assert json.load(f) == jj


# ---------------------------------------------------------------- copies
def test_cl_metrics_copy_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.randn(30, 8).astype(np.float32)
    b = (a + 0.3 * rng.randn(30, 8)).astype(np.float32)
    assert t_clm.uniform_loss(a) == j_clm.uniform_loss(a)
    assert t_clm.alignment_loss(a, b) == j_clm.alignment_loss(a, b)
    assert t_clm.retrieval_topk_accuracy(a, b, (1, 5)) == \
        j_clm.retrieval_topk_accuracy(a, b, (1, 5))
    assert t_clm.foscttm(b, a) == j_clm.foscttm(b, a)
    labels = rng.randint(0, 3, 30)
    for metric in ("cosine", "euclidean"):
        assert t_clm.knn_classifier(a, labels, b, labels, metric=metric,
                                    num_classes=3) == j_clm.knn_classifier(
            a, labels, b, labels, metric=metric, num_classes=3)
    got, gm = t_clm.embedding_plot_coords(a, method="pca")
    want, wm = j_clm.embedding_plot_coords(a, method="pca")
    assert gm == wm
    np.testing.assert_array_equal(got, want)


def test_geomca_copy_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    R = rng.randn(60, 5)
    E = R[:50] + 0.2 * rng.randn(50, 5)
    got = t_geo.geomca(R, E, comp_consistency_threshold=0.0,
                       comp_quality_threshold=0.0)
    want = j_geo.geomca(R, E, comp_consistency_threshold=0.0,
                        comp_quality_threshold=0.0)
    for f in ("epsilon", "network_consistency", "network_quality",
              "precision", "recall", "num_components"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.components.keys() == want.components.keys()
    for k, c in want.components.items():
        for name, v in c.items():
            np.testing.assert_array_equal(got.components[k][name], v)
    for mode, kw in (("sparsify", dict(min_dist=0.5)),
                     ("subsample", dict(n_samples=20))):
        np.testing.assert_array_equal(t_geo.reduce_points(R, mode, **kw),
                                      j_geo.reduce_points(R, mode, **kw))
    t_geo.geomca_logged(R, E, str(tmp_path / "port"), reduce="sparsify",
                        min_dist=0.3)
    j_geo.geomca_logged(R, E, str(tmp_path / "jax"), reduce="sparsify",
                        min_dist=0.3)
    for name in ("network_parameters.json", "network_stats.json",
                 "components_stats.json", "geomca.txt"):
        assert (tmp_path / "port" / name).read_text() == (
            tmp_path / "jax" / name).read_text(), name
