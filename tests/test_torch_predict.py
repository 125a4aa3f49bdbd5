"""The port's serving slice as a whole.

  * On a tiny model with the flagship's structure (GIN with 3-layer MLPs,
    2-layer 4-head HGT, chemCPA, 2-layer 8-head norm-first x-attn fusion
    with 2 tx bottlenecks, sinusoidal positions, transformer_uni_proj
    routing) and the same weights, the JAX package's embed_all_drugs,
    score_all_pairs and score_triples_for_pairs equal the port's (atol
    1e-5: the same f32 math, summed in another order).
  * The port's CLI runs end to end on the CPU from a port checkpoint.
  * Flags this slice does not port raise NotImplementedError.
  * Without a card, entry points that were not asked for the CPU raise.
  * Importing the port (and chip_smoke.py) loads no JAX, flax, pandas or
    madrigal_tpu module, and chip_smoke.py fails without a card.
"""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.eval import predict as j_predict
from madrigal_tpu.models.encoder import MadrigalMultilabel as JMultilabel
from madrigal_tpu.models.encoder import init_multilabel
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.cli import predict as t_cli
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import build_kg_batch, kg_schema
from madrigal_tpu_torch.data.molgraph import pack_molecules
from madrigal_tpu_torch.device import resolve_device
from madrigal_tpu_torch.eval import predict as t_predict
from madrigal_tpu_torch.interop.from_flax import load_flax_weights
from madrigal_tpu_torch.models.encoder import (
    MadrigalMultilabel,
    build_model,
    init_weights,
)
from madrigal_tpu_torch.ops.bilinear import bilinear_scores
from madrigal_tpu_torch.train.checkpoint import save_checkpoint
from test_torch_models import _perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = dict(num_drugs=18, num_labels=6, num_edges=30, seed=5)
DATA_FLAGS = ["--synthetic", "--synthetic_drugs", "18", "--synthetic_labels",
              "6", "--synthetic_edges", "30", "--seed", "5"]


def flagship_shaped(cfg_mod):
    """The flagship configuration's structure at narrow widths."""
    c = cfg_mod
    enc = c.EncoderConfig(
        feature_dim=16,
        gin=c.GINConfig(hidden_dims=(16, 16, 16), num_mlp_layer=3),
        hgt=c.HGTConfig(hidden_dim=16, num_layers=2, att_heads=4),
        cv=c.MLPEncoderConfig(hidden_dims=(32, 16)),
        chemcpa=c.ChemCPAConfig(dim=16, autoencoder_width=32,
                                autoencoder_depth=2, use_drugs=False),
        transformer=c.FusionConfig(num_layers=2, att_heads=8, head_dim=4,
                                   ffn_dim=32, dropout=0.2, actn="gelu",
                                   norm_first=True, agg="x-attn",
                                   num_tx_bottlenecks=2),
        proj=c.ProjectorConfig(hidden_dims=(32, 32)),
        pos_emb_type="sinusoidal", fusion="transformer_uni_proj",
        fusion_batch_chunk=5,
    )
    return c.TrainConfig(model=c.ModelConfig(encoder=enc, prediction_dim=6))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    dj, dt = j_syn.make_dataset(**DATA), t_syn.make_dataset(**DATA)
    cj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0,
                               kg_src_sort=False)
    ct = t_collate.DDICollator(dt, split="train", seed=5,
                               device="cpu")
    batch, kj = cj()
    j_model = JMultilabel(enc_cfg=flagship_shaped(j_config).model.encoder,
                          prediction_dim=6)
    v = init_multilabel(j_model, jax.random.PRNGKey(0), batch.head,
                        batch.tail, kj)
    v = _perturb(v, np.random.RandomState(0))
    cfg = flagship_shaped(t_config)
    model = MadrigalMultilabel(cfg.model.encoder, 6,
                               *kg_schema(dt.kg_node_feats,
                                          dt.kg_edge_indices))
    load_flax_weights(model, v)
    model.eval()
    path = str(tmp_path_factory.mktemp("ckpt") / "model.pt")
    save_checkpoint(path, model, cfg)
    return dict(dj=dj, cj=cj, kj=kj, j_model=j_model, v=v, ct=ct,
                kt=ct.kg_batch(), model=model, path=path)


TRIPLES = [(0, 1, 2), (5, 3, 4), (2, 0, 17), (3, 7, 7)]


def test_serving_path_matches_jax(served):
    s = served
    z_j = j_predict.embed_all_drugs(s["j_model"], s["v"], s["cj"], s["kj"],
                                    batch_size=7)
    z_t = t_predict.embed_all_drugs(s["model"], s["ct"], s["kt"],
                                    batch_size=7)
    np.testing.assert_allclose(z_t, z_j, atol=1e-5, rtol=1e-5)
    # every other drug keeps one modality: the unimodal route is compared
    masks = np.asarray(s["dj"].masks).copy()
    for i in range(0, len(masks), 2):
        keep = np.flatnonzero(~masks[i])[i % 3]
        masks[i] = True
        masks[i, keep] = False
    zm_j = j_predict.embed_all_drugs(s["j_model"], s["v"], s["cj"], s["kj"],
                                     eval_masks=masks)
    zm_t = t_predict.embed_all_drugs(s["model"], s["ct"], s["kt"],
                                     eval_masks=masks)
    np.testing.assert_allclose(zm_t, zm_j, atol=1e-5, rtol=1e-5)
    assert not np.allclose(zm_t[::2], z_t[::2], atol=1e-3)

    sc_j = j_predict.score_all_pairs(s["j_model"], s["v"], z_j,
                                     label_chunk=4)
    sc_t = t_predict.score_all_pairs(s["model"], z_t, label_chunk=4)
    assert sc_t.shape == (6, 18, 18) and sc_t.dtype == np.float32
    np.testing.assert_allclose(sc_t, sc_j, atol=1e-5, rtol=1e-5)

    tr_j = j_predict.score_triples_for_pairs(s["j_model"], s["v"], z_j,
                                             TRIPLES)
    tr_t = t_predict.score_triples_for_pairs(s["model"], z_t, TRIPLES)
    np.testing.assert_allclose(tr_t, tr_j, atol=1e-5, rtol=1e-5)
    for k, (l, a, b) in enumerate(TRIPLES):
        assert abs(tr_t[k] - sc_t[l, a, b]) < 1e-5


def test_score_all_pairs_head_tail_and_bf16(served):
    s = served
    z = t_predict.embed_all_drugs(s["model"], s["ct"], s["kt"])
    full = t_predict.score_all_pairs(s["model"], z, label_chunk=4)
    part = t_predict.score_all_pairs(s["model"], z[:5], z, label_chunk=5)
    np.testing.assert_allclose(part, full[:, :5], atol=1e-5, rtol=1e-5)
    before = bilinear_scores.launches
    bf = t_predict.score_all_pairs(s["model"], z, label_chunk=4,
                                   compute_dtype=torch.bfloat16)
    assert bilinear_scores.launches == before  # CPU: the plain version
    assert np.abs(bf - full).max() <= 2e-2 * np.abs(full).max()


def test_init_weights_is_seeded_and_complete(served):
    """A model from a seeded generator: the same seed gives the same
    weights, another seed other weights, and every weight is set (finite,
    and the scores it gives are finite)."""
    cfg = flagship_shaped(t_config)
    schema = kg_schema(served["ct"].ds.kg_node_feats,
                       served["ct"].ds.kg_edge_indices)

    def made(seed):
        m = build_model(cfg.model, *schema, device="cpu")
        return init_weights(m, torch.Generator().manual_seed(seed))

    a, b, c = made(3), made(3), made(4)
    for k, t in a.state_dict().items():
        assert torch.isfinite(t).all(), k
        torch.testing.assert_close(b.state_dict()[k], t, atol=0, rtol=0)
    assert not torch.equal(a.decoder.weight, c.decoder.weight)
    z = t_predict.embed_all_drugs(a, served["ct"], served["kt"])
    assert np.isfinite(t_predict.score_all_pairs(a, z)).all()


def test_checkpoint_roundtrip(served):
    s = served
    model, cfg = t_predict.model_from_checkpoint(s["path"], device="cpu")
    assert isinstance(cfg, t_config.TrainConfig)
    assert cfg == flagship_shaped(t_config)
    for k, t in s["model"].state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], t, atol=0, rtol=0)


def test_cli_end_to_end_on_cpu(served, tmp_path):
    s = served
    emb, scores = str(tmp_path / "z.npy"), str(tmp_path / "scores.npy")
    out = t_cli.main(["--checkpoint", s["path"], "--platform", "cpu",
                      "--export_embeddings", emb, "--export_scores", scores,
                      "--label_chunk", "4", "--kg_chunk", "8", "--no_src_mxu",
                      "--triples"] + [":".join(map(str, t)) for t in TRIPLES]
                     + DATA_FLAGS)
    z = t_predict.embed_all_drugs(s["model"], s["ct"], s["kt"])
    np.testing.assert_allclose(np.load(emb), z, atol=1e-6, rtol=1e-6)
    sc = np.load(scores)
    np.testing.assert_allclose(
        sc, t_predict.score_all_pairs(s["model"], z, label_chunk=4),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out, [sc[l, a, b] for l, a, b in TRIPLES],
                               atol=1e-5, rtol=1e-5)


def test_only_training_builds_the_source_sorted_layout():
    """The serving CLI's KG batch has the plain layout only (it runs no
    backward); the training CLI's has the source-sorted one unless
    --no_src_mxu."""
    from madrigal_tpu_torch.cli import common
    from madrigal_tpu_torch.cli import train_ddi

    flags = ["--platform", "cpu"] + DATA_FLAGS
    serve = t_cli.build_parser().parse_args(["--checkpoint", "x"] + flags)
    assert not common.load_data(serve, "cpu")[1].kg_batch().edge_src_order
    for extra, want in (([], True), (["--no_src_mxu"], False)):
        args = train_ddi.build_parser().parse_args(flags + extra)
        kg = train_ddi._load_train_data(args, "cpu")[1].kg_batch()
        assert bool(kg.edge_src_order) == want


@pytest.mark.parametrize("extra", [
    ["--export_ranks", "r.npy"], ["--eval_type", "full_full"],
    ["--ablation", "a.json"], ["--sharded"], ["CKPT2"],
    ["--platform", "tpu"]])
def test_unported_flags_raise(served, extra):
    argv = ["--checkpoint", served["path"]]
    if extra == ["CKPT2"]:
        argv.append(served["path"])
    else:
        argv += extra
    if "--platform" not in extra:
        argv += ["--platform", "cpu"]
    with pytest.raises(NotImplementedError):
        t_cli.main(argv + DATA_FLAGS)


def test_entry_points_refuse_without_card(served):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_predict.model_from_checkpoint(served["path"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["--checkpoint", served["path"]] + DATA_FLAGS)
    # the builders default to the card too
    ds = served["ct"].ds
    for build in (lambda: t_collate.DDICollator(ds),
                  lambda: build_kg_batch(ds.kg_node_feats,
                                         ds.kg_edge_indices, ds.kg_drug_ids),
                  lambda: pack_molecules(ds.molecules[:2]),
                  lambda: build_model(flagship_shaped(t_config).model,
                                      *kg_schema(ds.kg_node_feats,
                                                 ds.kg_edge_indices))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


_IMPORT_CHECK = """
import importlib, pkgutil, sys
import madrigal_tpu_torch
for m in pkgutil.walk_packages(madrigal_tpu_torch.__path__,
                               "madrigal_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "yaml",
          "sklearn", "madrigal_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(" ".join(sorted(m for m in sys.modules
                      if m.startswith("madrigal_tpu_torch."))))
sys.exit("loaded: " + ", ".join(bad) if bad else 0)
"""


def test_port_imports_no_jax_pandas_or_reference_package():
    res = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = set(res.stdout.split())
    assert len(loaded) >= 35  # every module was imported
    for m in ("cli.predict", "cli.train_ddi", "train.finetune",
              "train.optim", "train.losses", "train.masking",
              "train.checkpoint", "ops.segment_sorted", "ops.gather"):
        assert "madrigal_tpu_torch." + m in loaded, m


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
