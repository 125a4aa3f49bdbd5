"""The analysis layer in the port against the JAX package.

  * Every `ddi_queries` and `profiles` function against the JAX one on
    seeded tensors and inputs: equal, except `cv_validation_auroc`, whose
    logistic fits are scipy's L-BFGS-B (`fit_logistic_l2`) where the JAX
    package's are scikit-learn's: the same alpha, AUROC within 1e-6, and
    the coefficients within 1e-3 relative of scikit-learn's.
  * `cli.analyze`'s JSON against the JAX CLI's for each query flag, and
    its `.npy` outputs equal.
  * `pretrain_embedding_shift` against the JAX function: the JAX
    variables come from the port's encoder's two inits through
    `tests/test_torch_stage1.to_flax` (no JAX init compiles); the
    embedding tables within 1e-5, the alignments within 1e-6, the PCA
    coordinates within 1e-4 up to each axis's sign.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.analysis import ddi_queries as jq
from madrigal_tpu.analysis import pretrain_embeds as jpe
from madrigal_tpu.analysis import profiles as jp
from madrigal_tpu.cli import analyze as j_cli
from madrigal_tpu.data.collate import DDICollator as JCollator
from madrigal_tpu.data.synthetic import make_dataset as j_make_dataset
from madrigal_tpu.models.encoder import MadrigalEncoder as JEncoder
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.analysis import ddi_queries as tq
from madrigal_tpu_torch.analysis import pretrain_embeds as tpe
from madrigal_tpu_torch.analysis import profiles as tp
from madrigal_tpu_torch.cli import analyze as t_cli
from madrigal_tpu_torch.data.collate import DDICollator as TCollator
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.data.synthetic import make_dataset as t_make_dataset
from madrigal_tpu_torch.models.encoder import MadrigalEncoder as TEncoder
from madrigal_tpu_torch.models.encoder import init_weights
from test_torch_evaluate_pt import enc_cfg
from test_torch_stage1 import to_flax

L, N = 6, 20


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tensor():
    """A seeded [L, N, N] rank-like tensor: symmetric, in (0, 1], zero
    diagonal."""
    t = np.random.RandomState(3).rand(L, N, N).astype(np.float32) + 1e-3
    t = (t + t.transpose(0, 2, 1)) / 2
    t[:, np.arange(N), np.arange(N)] = 0
    return t


def assert_same(got, want):
    """Equal results, recursively (numpy arrays exactly, NaN equal)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)) and not isinstance(got, np.ndarray):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        np.testing.assert_array_equal(got, want)


def both(name, *args, mod=("q", "q"), **kw):
    j, t = {"q": (jq, tq), "p": (jp, tp)}[mod[0]]
    return getattr(t, name)(*args, **kw), getattr(j, name)(*args, **kw)


# ------------------------------------------------------------ ddi_queries
def test_tensor_queries_match_jax(tensor):
    assert_same(*both("self_combo_scores", tensor))
    pairs = [(3, 1), (19, 0), (5, 5)]
    assert_same(*both("pair_values", tensor, pairs))
    assert_same(*both("pair_values", tensor, pairs, labels=[0, 4]))
    for agg in ("gmean", "mean", "max"):
        assert_same(*both("aggregate_outcomes", tensor, [1, 2, 5], agg=agg))
    known = np.random.RandomState(1).rand(N, N) < 0.2
    mat = tensor[2]
    for largest in (True, False):
        for k in (1, 7, 500):
            assert_same(*both("topk_novel_pairs", mat, k, largest=largest))
            assert_same(*both("topk_novel_pairs", mat, k, known,
                              largest=largest))


def test_rank_enrichment_matches_jax(tensor):
    mat = tensor[1]
    cand = [(3, 1), (9, 4), (2, 17), (11, 10)]
    bg = [(5, 0), (8, 7), (19, 2), (6, 3), (12, 4)]
    for alt in ("greater", "less", "two-sided"):
        for b in (None, bg):
            got, want = both("rank_enrichment", mat, cand, b, alternative=alt)
            assert (got.statistic, got.pvalue) == (want.statistic,
                                                   want.pvalue)


def test_external_validation_matches_jax():
    rng = np.random.RandomState(5)
    y = (rng.rand(60) > 0.5).astype(float)
    vals = y + rng.randn(60)
    vals[4] = np.nan
    for kind in ("auto", "binary", "continuous"):
        assert_same(*both("external_validation", vals, y, kind=kind))
    assert_same(*both("external_validation", vals, np.tanh(vals + 1)))
    assert_same(*both("external_validation", vals, np.zeros(60),
                      kind="binary"))


def cv_data(seed):
    rng = np.random.RandomState(seed)
    y = (rng.rand(90) > 0.5).astype(float)
    x = np.stack([0.8 * y + rng.randn(90), rng.randn(90),
                  0.3 * y + rng.rand(90)], axis=1)
    return x, y


@pytest.mark.parametrize("seed", [0, 1])
def test_cv_validation_auroc_matches_jax(seed):
    x, y = cv_data(seed)
    got = tq.cv_validation_auroc(x, y, folds=4, seed=seed)
    want = jq.cv_validation_auroc(x, y, folds=4, seed=seed)
    assert got.keys() == want.keys()
    assert (got["alpha"], got["folds"]) == (want["alpha"], want["folds"])
    np.testing.assert_allclose(got["auroc"], want["auroc"], atol=1e-6)
    np.testing.assert_allclose(got["auroc_std"], want["auroc_std"],
                               atol=1e-6)
    with pytest.raises(ValueError):
        tq.cv_validation_auroc(x[:4], np.array([1.0, 0, 0, 0]))


@pytest.mark.parametrize("alpha", [1e-3, 1e-1, 10.0])
def test_logistic_fit_matches_sklearn(alpha):
    from sklearn.linear_model import LogisticRegression

    x, y = cv_data(2)
    clf = LogisticRegression(C=1.0 / alpha, max_iter=2000).fit(x, y)
    w, b = tq.fit_logistic_l2(x, y, C=1.0 / alpha)
    want = np.concatenate([clf.coef_[0], clf.intercept_])
    got = np.concatenate([w, [b]])
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())

    # scikit-learn stops at its tolerance first: this fit's objective is
    # no higher than scikit-learn's
    def objective(w, b):
        m = (2 * y - 1) * (x @ w + b)
        return 0.5 * w @ w + np.logaddexp(0, -m).sum() / alpha

    assert objective(w, b) <= objective(clf.coef_[0], clf.intercept_[0])


def test_outcome_mapper_matches_jax(tmp_path):
    mapper = {"neutropenia": {"twosides": ["Neutropenia", "agranulocytosis"],
                              "TWOSIDES": ["x"]}}
    path = tmp_path / "mapper.json"
    path.write_text(json.dumps(mapper))
    assert tq.load_outcome_mapper(str(path)) == jq.load_outcome_mapper(
        str(path))
    names = ["headache", "NEUTROPENIA", "Agranulocytosis", "x"]
    for ds in ("twosides", "TWOSIDES", "other"):
        assert_same(*both("map_outcome_labels", mapper, "neutropenia", ds,
                          names))


# --------------------------------------------------------------- profiles
def test_profiles_match_jax(tmp_path):
    p = ("p", "p")
    for squash in (False, True):
        assert_same(*both("normalize_name", "MEK-162 x_y", squash, mod=p))
        assert_same(*both("match_drug_names", ["taxol", "mek162", "none"],
                          [["Paclitaxel", "taxol"], ["MEK-162"], ["taxol"]],
                          squash=squash, mod=p))
    organs = tmp_path / "organs.csv"
    organs.write_text("ddi_class\torgan\nA, increase\theart\n"
                      "B, increase\tliver, blood\n\nC, decrease\tkidney\n")
    organ_map = tp.load_organ_map(str(organs))
    assert organ_map == jp.load_organ_map(str(organs))
    classes = ["A, increase", "B, increase", "C, decrease", "D"]
    assert_same(*both("organ_class_groups", classes, organ_map,
                      exclude=["C, decrease"], mod=p))
    t = np.random.RandomState(0).rand(4, 6, 6)
    for om in (None, organ_map):
        assert_same(*both("combo_class_table", t, [(4, 1), (2, 5)],
                          ["p0", "p1"], classes, om,
                          exclude=["C, decrease"], mod=p))
    pairs, labels = [(0, 1), (0, 2), (1, 2), (3, 1)], [0, 1, 1, 2]
    for kind in ("partner", "label", "partner_label"):
        prof, want = both("ddi_profile_matrix", pairs, 5, labels, kind=kind,
                          mod=p)
        assert_same(prof, want)
        assert_same(*both("jaccard_similarity", prof, mod=p))
    assert_same(*both("lower_triangle_pairs", 5, mod=p))
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.uniform(-0.5, 0, 30), rng.uniform(0, 1, 120)])
    y = 0.2 + 0.5 * np.clip(x, 0, 1) + rng.rand(150) * 0.05
    for nb in (True, False):
        assert_same(*both("binned_similarity_compare", x, y, 3, nb, mod=p))
    sim = rng.rand(400)
    overlap = (rng.rand(400) < 0.3).astype(float)
    assert_same(*both("high_similarity_contrast", sim, overlap,
                      rng.randn(400), threshold=0.9, n_background=200,
                      mod=p))


# --------------------------------------------------------------- the CLI
def run_cli(main, argv, out_dir, capsys):
    """The CLI's JSON, with `out_dir` written as '{out}'."""
    main(argv)
    return json.loads(capsys.readouterr().out.replace(str(out_dir),
                                                      "{out}"))


def test_analyze_cli_matches_jax(tensor, tmp_path, capsys):
    tpath = tmp_path / "ranks.npy"
    np.save(tpath, tensor)
    mat = tensor[2].astype(np.float64)
    top, _ = jq.topk_novel_pairs(mat, 8)
    bot, _ = jq.topk_novel_pairs(mat, 8, largest=False)
    pairs = np.concatenate([top, bot])
    np.savetxt(tmp_path / "cand.csv", top[:5], fmt="%d")
    np.savetxt(tmp_path / "bg.csv", bot, fmt="%d")
    np.save(tmp_path / "known.npy", np.random.RandomState(2).rand(N, N) < .1)
    binary = np.column_stack([pairs, np.repeat([1.0, 0.0], 8)])
    binary[[1, 12], 2] = binary[[12, 1], 2]  # not separable
    np.savetxt(tmp_path / "val.csv", binary, fmt="%.1f")
    np.savetxt(tmp_path / "valc.csv", np.column_stack(
        [pairs, np.random.RandomState(4).randn(16)]))
    (tmp_path / "mapper.json").write_text(json.dumps(
        {"neutro": {"twosides": ["L1", "L3"]}}))
    (tmp_path / "names.txt").write_text("L0\nL1\nL2\nL3\nL4\nL5\n")
    t = str(tpath)
    queries = [
        ["--pairs", "3:1", "19:0", "--labels", "0,2"],
        ["--self_combo", "{out}/sc.npy"],
        ["--label", "1", "--topk", "5", "--known", f"{tmp_path}/known.npy"],
        ["--label", "4", "--topk", "3", "--smallest"],
        ["--label", "2", "--enrich", f"{tmp_path}/cand.csv"],
        ["--label", "2", "--enrich", f"{tmp_path}/cand.csv", "--background",
         f"{tmp_path}/bg.csv", "--alternative", "two-sided"],
        ["--aggregate", "gmean", "--labels", "0,2,5", "--out",
         "{out}/agg.npy", "--topk", "4", "--enrich",
         f"{tmp_path}/cand.csv"],
        ["--aggregate", "max", "--labels", "1,3", "--validate",
         f"{tmp_path}/valc.csv"],
        ["--label", "2", "--validate", f"{tmp_path}/val.csv"],
        ["--label", "2", "--validate", f"{tmp_path}/valc.csv"],
        ["--labels", "0,2,4", "--cv_auroc", "--validate",
         f"{tmp_path}/val.csv"],
        ["--pairs", "3:1", "--outcome", "neutro", "--outcome_mapper",
         f"{tmp_path}/mapper.json", "--label_names",
         f"{tmp_path}/names.txt"],
    ]
    for q in queries:
        out = {}
        for name, main in (("j", j_cli.main), ("t", t_cli.main)):
            d = tmp_path / name
            d.mkdir(exist_ok=True)
            argv = ["--tensor", t] + [a.format(out=d) for a in q]
            out[name] = run_cli(main, argv, d, capsys)
            for a in argv:
                if a.startswith(str(d)):
                    out[name + a[len(str(d)):]] = np.load(a)
        want, got = out.pop("j"), out.pop("t")
        if "cv_auroc" in want:
            for k in ("auroc", "auroc_std"):
                np.testing.assert_allclose(got["cv_auroc"].pop(k),
                                           want["cv_auroc"].pop(k),
                                           atol=1e-6)
        assert got == want, q
        for k in [k for k in out if k.startswith("j/")]:
            np.testing.assert_array_equal(out["t" + k[1:]], out[k])
    assert "cv_auroc" in str(queries)


# --------------------------------------------------------- pretrain_embeds
DATA = dict(num_drugs=20, num_labels=4, num_edges=20, seed=40)


@pytest.fixture(scope="module")
def shift_setup():
    dj, dt = j_make_dataset(**DATA), t_make_dataset(**DATA)
    cj = JCollator(dj, split="train")
    ct = TCollator(dt, split="train", device="cpu")
    tenc = TEncoder(enc_cfg(t_config),
                    *kg_schema(dt.kg_node_feats, dt.kg_edge_indices))
    states = []
    for seed in (0, 7):
        init_weights(tenc, torch.Generator().manual_seed(seed))
        states.append({k: v.clone() for k, v in tenc.state_dict().items()})
    jenc = JEncoder(cfg=enc_cfg(j_config))

    @functools.partial(jax.jit, static_argnums=3)
    def apply_fn(vs, batch, kg, raw):
        return jenc.apply(
            vs, batch, kg, train=False, raw_encoder_output=raw,
            method=lambda m, b, k, train, raw_encoder_output: m.encode(
                b, kg=k, train=train, raw_encoder_output=raw_encoder_output))

    jvars = []
    for sd in states:
        tenc.load_state_dict(sd)
        params, stats = to_flax(tenc)
        jvars.append({"params": params, "batch_stats": stats})
    return (tenc, states, ct, ct.kg_batch()), (apply_fn, jvars, cj,
                                                cj.kg_batch())


def test_pretrain_embedding_shift_matches_jax(shift_setup, monkeypatch):
    (tenc, states, ct, kt), (apply_fn, jvars, cj, kj) = shift_setup
    tables = {"j": [], "t": []}
    for name, mod in (("j", jpe), ("t", tpe)):
        orig = mod.modality_embedding_table

        def record(*args, orig=orig, name=name, **kw):
            tables[name].append(orig(*args, **kw))
            return tables[name][-1]

        monkeypatch.setattr(mod, "modality_embedding_table", record)
    mods = (0, 1, 2)
    got = tpe.pretrain_embedding_shift(tenc, states[0], states[1], ct, kt,
                                       n_drugs=4, modality_indices=mods,
                                       method="pca")
    want = jpe.pretrain_embedding_shift(apply_fn, jvars[0], jvars[1], cj, kj,
                                        n_drugs=4, modality_indices=mods,
                                        method="pca")
    assert len(tables["t"]) == len(tables["j"]) == 2
    for g, w in zip(tables["t"], tables["j"]):
        for k in ("modality", "drug"):
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_allclose(g["embeds"], w["embeds"], atol=1e-5,
                                   rtol=1e-5)
    for k in ("drugs", "modality", "drug"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["drugs"]) == 4 and set(got["modality"]) == set(mods)
    assert got["projection"] == want["projection"] == "pca"
    for k in ("before", "after"):
        np.testing.assert_allclose(got["alignment"][k],
                                   want["alignment"][k], atol=1e-6)
    assert got["alignment"]["before"] != got["alignment"]["after"]
    for k in ("coords_before", "coords_after"):
        g, w = got[k], want[k]
        sign = np.sign((g * w).sum(0))
        np.testing.assert_allclose(g * sign, w, atol=1e-4)
    # the encoder is left holding the second state
    assert all(torch.equal(v, states[1][k])
               for k, v in tenc.state_dict().items())
