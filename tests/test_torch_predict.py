"""The port's serving slice as a whole.

  * On a tiny model with the flagship's structure (GIN with 3-layer MLPs,
    2-layer 4-head HGT, chemCPA, 2-layer 8-head norm-first x-attn fusion
    with 2 tx bottlenecks, sinusoidal positions, transformer_uni_proj
    routing) and the same weights, the JAX package's embed_all_drugs,
    score_all_pairs and score_triples_for_pairs equal the port's (atol
    1e-5: the same f32 math, summed in another order).
  * The port's CLI runs end to end on the CPU from a port checkpoint.
  * With two checkpoints of the same weights in each package, the port's
    CLI (--export_ranks, --export_scores, --export_embeddings, --triples,
    --eval_type, --keep_seed_ranks, --ablation / --ablation_combos)
    against `madrigal_tpu.cli.predict`: embeddings, sigmoid-mean scores
    and triple probabilities within 1e-5; each seed's raw scores as in
    the first bullet, and its ranks identical at
    every pair whose score is further than max(1e-5, twice the largest
    score difference) from every other score of its outcome, and the
    ensemble ranks identical on every outcome where that holds for all
    pairs of both seeds; the ablation table's subsets, labels and
    positives equal (its metrics are held to JAX in test_torch_eval.py),
    and equal to the port's library call. Without --keep_seed_ranks the
    seed files are gone and the ranks the same.
  * --sharded, the one flag not ported, raises NotImplementedError.
  * Without a card, entry points that were not asked for the CPU raise.
  * Importing the port (and chip_smoke.py) loads no JAX, flax, pandas or
    madrigal_tpu module, and chip_smoke.py fails without a card.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.cli import predict as j_cli
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.eval import predict as j_predict
from madrigal_tpu.models.encoder import MadrigalMultilabel as JMultilabel
from madrigal_tpu.models.encoder import init_multilabel
from madrigal_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.cli import predict as t_cli
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import build_kg_batch, kg_schema
from madrigal_tpu_torch.data.molgraph import pack_molecules
from madrigal_tpu_torch.device import resolve_device
from madrigal_tpu_torch.eval import ablation as t_ablation
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
from test_torch_ranks import separated
from test_torch_train import one_thread  # noqa: F401  (fixture)

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


@pytest.mark.parametrize("logits", [True, False],
                         ids=["logits", "probabilities"])
def test_ensemble_sigmoid_mean_matches_jax(logits):
    """Three seeds' triple scores, as logits (some inside [0, 1], which
    must still be sigmoided) or as probabilities: the port's mean equals
    the JAX package's within 1e-7."""
    rng = np.random.RandomState(4)
    sets = [rng.randn(40).astype(np.float32) for _ in range(3)]
    sets[0][:10] = rng.uniform(0, 1, 10)
    if not logits:
        sets = [1 / (1 + np.exp(-s)) for s in sets]
    got = t_predict.ensemble_sigmoid_mean(sets, scores_are_logits=logits)
    want = np.asarray(j_predict.ensemble_sigmoid_mean(
        sets, scores_are_logits=logits))
    assert got.shape == (40,)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    if not logits:
        np.testing.assert_allclose(got, np.mean(sets, axis=0), atol=1e-7,
                                   rtol=0)


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
    ["--sharded", "--export_ranks", "r.npy"],
    ["--sharded", "--eval_type", "full_full"],
    ["--sharded", "--ablation", "a.json", "--ablation_combos",
     "str;str+kg+cv+tx"], ["--sharded"],
    ["--sharded", "CKPT2"], ["--platform", "tpu"]])
def test_unported_flags_raise(served, extra, tmp_path):
    """--platform tpu raises before any output is written. --sharded,
    which raised the same way until the multi-GPU slice, now runs,
    whatever it is combined with: run without torchrun it is a one-rank
    group, and it writes and returns exactly what the run without it
    does (tests/test_torch_parallel.py runs it on 2 ranks). The ablation
    study runs two of its combinations: their number is not what is
    checked."""
    def run(out):
        out.mkdir()
        argv = ["--checkpoint", served["path"]]
        if "CKPT2" in extra:
            argv.append(served["path"])
        argv += [str(out / a) if a.endswith((".npy", ".json")) else a
                 for a in extra if a != "CKPT2"]
        if "--platform" not in extra:
            argv += ["--platform", "cpu"]
        return t_cli.main(argv + DATA_FLAGS)

    if "--sharded" not in extra:
        with pytest.raises(NotImplementedError):
            run(tmp_path / "out")
        assert not os.listdir(tmp_path / "out")
        return
    got = run(tmp_path / "sharded")
    extra = [a for a in extra if a != "--sharded"]
    want = run(tmp_path / "plain")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    names = sorted(os.listdir(tmp_path / "plain"))
    assert sorted(os.listdir(tmp_path / "sharded")) == names
    for name in names:
        a, b = (tmp_path / d / name for d in ("sharded", "plain"))
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert json.loads(a.read_text()) == json.loads(b.read_text())


@pytest.fixture(scope="module")
def two_seeds(served, tmp_path_factory):
    """Two checkpoints of the same weights in each package: the served
    model's and a second seed's."""
    s = served
    d = tmp_path_factory.mktemp("seeds")
    batch, _ = s["cj"](build_kg=False)
    v2 = _perturb(init_multilabel(s["j_model"], jax.random.PRNGKey(1),
                                  batch.head, batch.tail, s["kj"]),
                  np.random.RandomState(1))
    cfg = flagship_shaped(t_config)
    model2 = MadrigalMultilabel(cfg.model.encoder, 6,
                                *kg_schema(s["ct"].ds.kg_node_feats,
                                           s["ct"].ds.kg_edge_indices))
    load_flax_weights(model2, v2)
    model2.eval()
    t2 = str(d / "t2.pt")
    save_checkpoint(t2, model2, cfg)
    jpaths = []
    for i, v in enumerate((s["v"], v2)):
        jpaths.append(str(d / f"j{i}"))
        j_save_checkpoint(jpaths[-1], v["params"], v.get("batch_stats", {}),
                          flagship_shaped(j_config), epoch=1)
    return dict(j=jpaths, t=[s["path"], t2], models=[s["model"], model2],
                v=[s["v"], v2])


ENSEMBLE_TRIPLES = ["0:1:2", "5:3:4", "2:0:17"]
COMBOS = "str;str+kg+cv+tx"


def test_two_checkpoint_cli_matches_jax(served, two_seeds, tmp_path):
    s, seeds = served, two_seeds

    def run(cli, pkg, ckpts, *extra):
        out = tmp_path / pkg
        out.mkdir(exist_ok=True)
        res = cli.main(
            ["--checkpoint", *ckpts, "--export_ranks", str(out / "r.npy"),
             "--export_scores", str(out / "s.npy"),
             "--export_embeddings", str(out / "z.npy"),
             "--eval_type", "str+tx_full", "--label_chunk", "4",
             "--triples", *ENSEMBLE_TRIPLES, *extra]
            + DATA_FLAGS + ["--platform", "cpu"])
        return res, out

    probs_j, jd = run(j_cli, "jax", seeds["j"], "--keep_seed_ranks",
                      "--ablation", str(tmp_path / "a_jax.json"),
                      "--ablation_combos", COMBOS)
    probs_t, td = run(t_cli, "port", seeds["t"], "--keep_seed_ranks",
                      "--ablation", str(tmp_path / "a.json"),
                      "--ablation_combos", COMBOS)
    tol = dict(atol=1e-5, rtol=0)
    z_j, z_t = np.load(jd / "z.npy"), np.load(td / "z.npy")
    assert z_t.shape == (2, 18, 16)
    np.testing.assert_allclose(z_t, z_j, **tol)
    np.testing.assert_allclose(np.load(td / "s.npy"), np.load(jd / "s.npy"),
                               **tol)
    np.testing.assert_allclose(probs_t, probs_j, **tol)
    assert ((probs_t > 0) & (probs_t < 1)).all()

    # per-seed ranks where the scores are separated, and the ensemble on
    # the outcomes where every pair of both seeds is
    clean = np.ones(6, bool)
    for i in range(2):
        sc_j = j_predict.score_all_pairs(s["j_model"], seeds["v"][i],
                                         z_j[i], label_chunk=4)
        sc_t = t_predict.score_all_pairs(seeds["models"][i], z_t[i],
                                         label_chunk=4)
        np.testing.assert_allclose(sc_t, sc_j, atol=1e-5, rtol=1e-5)
        err = np.abs(sc_t - sc_j).max()
        sep = separated(sc_j, max(1e-5, 2 * err))
        off_diag = ~np.eye(18, dtype=bool)
        clean &= sep[:, off_diag].all(axis=1)
        r_j = np.load(str(jd / "r.npy") + f".seed{i}.npy")
        r_t = np.load(str(td / "r.npy") + f".seed{i}.npy")
        np.testing.assert_array_equal(r_t[sep], r_j[sep])
    assert clean.sum() >= 3
    ens_t = np.load(td / "r.npy")
    np.testing.assert_array_equal(ens_t[clean], np.load(jd / "r.npy")[clean])
    assert not np.array_equal(ens_t, r_t)

    # the ablation study on the first checkpoint: the protocol matches
    # JAX's, the numbers the port's library call
    with open(tmp_path / "a.json") as f:
        table = json.load(f)
    with open(tmp_path / "a_jax.json") as f:
        table_j = json.load(f)
    assert list(table) == list(table_j)
    for combo, row in table_j.items():
        assert list(table[combo]) == list(row)
        for k in ("labels", "pos_samples"):
            assert table[combo][k] == row[k]
    batch, _ = s["ct"](build_kg=False)
    lib = t_ablation.modality_ablation_study(
        seeds["models"][0], batch, s["kt"], "str_random_sample",
        combos=[tuple(c.split("+")) for c in COMBOS.split(";")])
    assert list(table) == list(lib) == COMBOS.split(";")
    for combo, row in lib.items():
        for k, v in row.items():
            np.testing.assert_array_equal(np.asarray(table[combo][k]),
                                          np.asarray(v, np.float64))

    # without --keep_seed_ranks: the same ranks, and no seed files left
    run(t_cli, "port_nokeep", seeds["t"])
    nd = tmp_path / "port_nokeep"
    np.testing.assert_array_equal(np.load(nd / "r.npy"), ens_t)
    assert sorted(os.listdir(nd)) == ["r.npy", "s.npy", "z.npy"]
    assert os.path.exists(str(td / "r.npy") + ".seed1.npy")


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
import importlib, pkgutil, sys, tempfile
import torch
# one thread: the tier-1 lane runs this beside its other workers, and
# spinning intra-op threads on a full host only wait for each other
torch.set_num_threads(1)
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "yaml",
          "sklearn", "umap", "matplotlib", "transformers", "madrigal_tpu")
for name in banned:  # as on the card's machine: importing them fails
    sys.modules[name] = None
import madrigal_tpu_torch
for m in pkgutil.walk_packages(madrigal_tpu_torch.__path__,
                               "madrigal_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from madrigal_tpu_torch.cli import train_ddi
from madrigal_tpu_torch.data import datasets, synthetic
with tempfile.TemporaryDirectory() as root:
    ds = synthetic.make_dataset(num_drugs=12, num_labels=3, num_edges=20)
    datasets.export_synthetic_as_reference_layout(ds, root)
    back = datasets.load_reference_dataset(root, featurizer_backend="native")
    assert (back.tx_table == ds.tx_table).all()
    res = train_ddi.main([
        "--platform", "cpu", "--data_dir", root, "--num_epochs", "1",
        "--save_dir", root + "/out", "--set", "optim.optimizer=radam",
        "--set", "model.encoder.hgt.hidden_dim=64",
        "--set", "model.encoder.transformer.num_layers=1"])
    assert len(res["losses"]) == 1
    from madrigal_tpu_torch.cli import chemcpa_sweep, modality_pretrain
    from madrigal_tpu_torch.cli import pretrain
    # the sweep on a .json file; its best tx encoder warm-starts stage 2
    import json
    with open(root + "/sweep.json", "w") as f:
        json.dump({"fixed": {"training.num_epochs": 2,
                             "model.hparams.dim": 16,
                             "model.hparams.autoencoder_width": 16,
                             "model.hparams.autoencoder_depth": 1}}, f)
    sweep = chemcpa_sweep.main([
        "--platform", "cpu", "--synthetic", "--synthetic_drugs", "12",
        "--sweep_yaml", root + "/sweep.json", "--save_dir", root + "/sw"])
    stage1 = [modality_pretrain.main([
        "--platform", "cpu", "--synthetic", "--synthetic_drugs", "12",
        "--num_epochs", "2", "--feature_dim", "16", "--modality", mod,
        "--save_dir", root + "/s1"] + extra) for mod, extra in (
            ("kg", ["--hgt_hidden_dim", "8", "--hgt_att_heads", "2"]),
            ("tx", ["--tx_width", "16", "--tx_depth", "1", "--enable_adv",
                    "--eval_disentanglement"]))]
    res = pretrain.main([
        "--platform", "cpu", "--synthetic", "--synthetic_drugs", "12",
        "--num_steps", "2", "--batch_size", "8", "--save_checkpoints", "1",
        "--final_embeds_eval", "--save_dir", root + "/cl",
        "--modality_ckpts", *stage1, sweep["checkpoint"],
        "--set", "encoder.feature_dim=16",
        "--set", "encoder.gin.hidden_dims=[16]",
        "--set", "encoder.hgt.hidden_dim=8",
        "--set", "encoder.hgt.att_heads=2",
        "--set", "encoder.cv.hidden_dims=[16]",
        "--set", "encoder.chemcpa.dim=16",
        "--set", "encoder.chemcpa.autoencoder_width=16",
        "--set", "encoder.chemcpa.autoencoder_depth=1",
        "--set", "encoder.transformer.num_layers=1",
        "--set", "encoder.transformer.head_dim=8",
        "--set", "encoder.transformer.ffn_dim=16",
        "--set", "encoder.proj.hidden_dims=[16]",
        "--set", "moco_mlp_dim=16"])
    assert len(res["losses"]) == 2 and res["final_embeds"]
    # the LM head and the analysis CLI
    import numpy as np
    from madrigal_tpu_torch.cli import analyze, train_lm
    res = train_lm.main([
        "--platform", "cpu", "--synthetic", "--synthetic_drugs", "12",
        "--num_epochs", "1", "--project_dim", "8", "--mlp_dim", "16",
        "--save_dir", root + "/lm"])
    assert len(res["losses"]) == 1
    t = np.random.RandomState(0).rand(3, 12, 12).astype(np.float32)
    np.save(root + "/r.npy", t)
    np.savetxt(root + "/v.csv", [[1, 0, 1], [2, 0, 0], [3, 1, 1], [4, 2, 0],
                                 [5, 3, 1], [6, 4, 0]], fmt="%d")
    analyze.main(["--tensor", root + "/r.npy", "--labels", "0,2",
                  "--cv_auroc", "--validate", root + "/v.csv"])
    analyze.main(["--tensor", root + "/r.npy", "--label", "1",
                  "--validate", root + "/v.csv"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in banned and sys.modules[m] is not None)
print(" ".join(sorted(m for m in sys.modules
                      if m.startswith("madrigal_tpu_torch."))))
sys.exit("loaded: " + ", ".join(bad) if bad else 0)
"""


def test_port_imports_no_jax_pandas_or_reference_package():
    """Every module imports, and the exporter, the loader (with the native
    featurizer), the training CLI on --data_dir, the stage-1 CLI (kg, and
    tx with its adversaries and probe), 2 steps of the stage-2 CLI
    warm-started from those checkpoints and the chemCPA sweep's best
    (the sweep on a .json file) with its final-embeddings evaluation, the
    LM decoder and the analysis CLI (--cv_auroc and binary --validate)
    run, with JAX, flax,
    optax, orbax, pandas, pyyaml, scikit-learn, umap, matplotlib,
    transformers and the JAX package unimportable."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = set(res.stdout.split())
    assert len(loaded) >= 40  # every module was imported
    for m in ("cli.predict", "cli.train_ddi", "train.finetune",
              "train.optim", "train.losses", "train.masking",
              "train.checkpoint", "ops.segment_sorted", "ops.gather",
              "eval.ranks", "eval.masks", "eval.metrics", "eval.evaluate",
              "eval.ablation", "eval.predict", "data.datasets",
              "data.featurize", "data.native_featurizer", "data.smiles",
              "cli.pretrain", "models.simclr", "train.pretrain_cl",
              "train.pretrain_masks", "data.pipeline", "eval.evaluate_pt",
              "eval.cl_metrics", "eval.geomca", "cli.modality_pretrain",
              "train.modality_pretrain", "train.transfer", "models.gat",
              "models.kg_alt", "models.vae", "data.kg_sampling",
              "interop.convert_checkpoint", "interop.torch_convert",
              "utils.config_gen", "train.chemcpa_sweep",
              "cli.chemcpa_sweep", "models.lm_decoder", "train.lm_decoder",
              "cli.train_lm", "analysis", "analysis.ddi_queries",
              "analysis.profiles", "analysis.pretrain_embeds",
              "cli.analyze", "utils.profiling", "parallel",
              "parallel.mesh", "parallel.multihost", "parallel.collectives",
              "parallel.kg_shard", "parallel.allpairs",
              "parallel.train_step", "parallel.dryrun"):
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
