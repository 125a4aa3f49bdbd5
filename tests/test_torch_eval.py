"""The port's evaluation modules against the JAX package's, on the CPU.

  * `eval/masks.py` (a copy): the same masks for every eval type and
    finetune mode, and the same constants.
  * `eval/metrics.py` without scikit-learn: the port's numpy metrics
    against the JAX package's scikit-learn-backed ones within 1e-12, on
    random, tied, single-class and k-larger-than-group inputs; its six
    numpy functions against scikit-learn's.
  * `Evaluator.evaluate_ft` on a small model carried across with
    `from_flax`: the same key metric and `best_metrics` within 1e-5 (the
    same f32 model summed in another order), on a val split (its default
    sweep, and asymmetric eval types under the undirecting rule) and on
    the train split (the directed-pairs rule); `make_predictions` within
    1e-5.
  * `save_scores_and_stratified_metrics`: CSVs (csv module) whose header
    equals the pandas version's and whose rows parse to its values.
  * `modality_ablation_study`: the same table within 1e-5.
"""
import csv
import warnings

import jax
import numpy as np
import pytest
import sklearn.metrics as skm
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.eval import ablation as j_ablation
from madrigal_tpu.eval import evaluate as j_evaluate
from madrigal_tpu.eval import masks as j_masks
from madrigal_tpu.eval import metrics as j_metrics
from madrigal_tpu.eval import predict as j_predict
from madrigal_tpu.models.encoder import MadrigalMultilabel as JMultilabel
from madrigal_tpu.models.encoder import init_multilabel
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.eval import ablation as t_ablation
from madrigal_tpu_torch.eval import evaluate as t_evaluate
from madrigal_tpu_torch.eval import masks as t_masks
from madrigal_tpu_torch.eval import metrics as t_metrics
from madrigal_tpu_torch.eval import predict as t_predict
from madrigal_tpu_torch.interop.from_flax import load_flax_weights
from madrigal_tpu_torch.models.encoder import MadrigalMultilabel
from test_torch_models import _perturb
from test_torch_predict import flagship_shaped
from test_torch_train import one_thread  # noqa: F401  (fixture)


# ---------------------------------------------------------------- masks
EVAL_TYPES = sorted({t for ts in j_evaluate.SPLIT_EVAL_TYPES.values()
                     for t in ts} | {"kg_full", "tx_str", "str+kg+cv_full"})


@pytest.mark.parametrize("mode", t_config.FINETUNE_MODES)
def test_masks_copy_matches_jax(mode):
    base = t_syn.make_dataset(num_drugs=16, num_labels=4, num_edges=20,
                              seed=1).masks
    tail = np.roll(base, 3, axis=0)
    for et in EVAL_TYPES:
        for got, want in zip(
                t_masks.get_evaluate_masks(base, tail, et, mode),
                j_masks.get_evaluate_masks(base, tail, et, mode)):
            np.testing.assert_array_equal(got, want, err_msg=et)
    assert t_masks.MODALITY2NUMBER_LIST == j_masks.MODALITY2NUMBER_LIST
    assert t_masks.MODEL_SELECTION_EVAL_TYPE == \
        j_masks.MODEL_SELECTION_EVAL_TYPE
    assert list(t_masks.powerset("abc")) == list(j_masks.powerset("abc"))


# -------------------------------------------------------------- metrics
def metric_case(case: str, rng):
    """(preds, ys, labels, k) for one kind of input."""
    n = 240
    labels = rng.randint(0, 6, n)
    ys = (rng.rand(n) < 0.4).astype(np.int64)
    k = 5
    if case == "random":
        preds = rng.rand(n)
    elif case == "tied":
        preds = rng.randint(0, 5, n) / 4.0  # many exact ties, 0.5 included
    elif case == "single_class":
        preds = rng.rand(n).astype(np.float32)
        ys[labels == 2] = 0
        ys[labels == 4] = 1
    else:  # k larger than every label group
        preds = rng.rand(n)
        k = 100
    return preds, ys, labels, k


def assert_metrics_equal(got, want, tol):
    assert list(got) == list(want)
    for name in want:
        g = np.asarray(got[name], np.float64)
        w = np.asarray(want[name], np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)],
                                   atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ["random", "tied", "single_class",
                                  "k_over_group"])
@pytest.mark.parametrize("average", ["macro", "weighted", "micro", None])
def test_metrics_match_jax(case, average):
    preds, ys, labels, k = metric_case(case, np.random.RandomState(2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's undefined-metric notes
        want, pos_w = j_metrics.get_metrics(preds, ys, labels, k=k,
                                            average=average)
        got, pos_g = t_metrics.get_metrics(preds, ys, labels, k=k,
                                           average=average)
        # multiclass context adds Cohen's kappa; binary task
        want_b = j_metrics.get_metrics_binary(preds, ys, k, "multiclass")
        got_b = t_metrics.get_metrics_binary(preds, ys, k, "multiclass")
    assert_metrics_equal(got, want, 1e-12)
    assert_metrics_equal(got_b, want_b, 1e-12)
    np.testing.assert_array_equal(pos_g, pos_w)


@pytest.mark.parametrize("case", ["random", "tied", "single_class"])
def test_numpy_functions_match_sklearn(case):
    rng = np.random.RandomState(3)
    for trial in range(40):
        n = rng.randint(2, 50)
        preds, ys, _, _ = metric_case(case, rng)
        preds, ys = preds[:n], ys[:n]
        if case == "single_class":
            ys[:] = trial % 2
        rounded = np.round(preds)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for got, want in zip(t_metrics.precision_recall_curve(ys, preds),
                                 skm.precision_recall_curve(ys, preds)):
                np.testing.assert_array_equal(got, want)
            pairs = [
                (t_metrics.matthews_corrcoef(ys, rounded),
                 skm.matthews_corrcoef(ys, rounded)),
                (t_metrics.cohen_kappa_score(ys, rounded),
                 skm.cohen_kappa_score(ys, rounded))]
            if ys.any():
                pairs.append((t_metrics.average_precision_score(ys, preds),
                              skm.average_precision_score(ys, preds)))
            if len(np.unique(ys)) == 2:
                pairs.append((t_metrics.roc_auc_score(ys, preds),
                              skm.roc_auc_score(ys, preds)))
            np.testing.assert_array_equal(
                t_metrics.confusion_matrix(ys, rounded, labels=[0, 1]),
                skm.confusion_matrix(ys, rounded, labels=[0, 1]))
        for got, want in pairs:
            assert (np.isnan(got) and np.isnan(want)) or \
                abs(got - want) <= 1e-12, (got, want)


# ---------------------------------------------------- model and batches
DATA = dict(num_drugs=20, num_labels=6, num_edges=40, seed=11)


@pytest.fixture(scope="module")
def carried():
    """The same small model in both packages, and the same batches."""
    dj, sj = j_syn.make_split_dataset(**DATA)
    dt, st = t_syn.make_split_dataset(**DATA)
    bj, kj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0,
                                   kg_src_sort=False)()
    vj = j_collate.DDICollator(dj, split="val", kg_edge_chunk=0,
                               kg_src_sort=False)(sj["val"], build_kg=False)[0]
    tc = t_collate.DDICollator(dt, split="train", device="cpu")
    bt, kt = tc()
    vt = t_collate.DDICollator(dt, split="val", device="cpu")(
        st["val"], build_kg=False)[0]
    j_model = JMultilabel(enc_cfg=flagship_shaped(j_config).model.encoder,
                          prediction_dim=6)
    v = _perturb(init_multilabel(j_model, jax.random.PRNGKey(1), bj.head,
                                 bj.tail, kj), np.random.RandomState(1))
    model = MadrigalMultilabel(flagship_shaped(t_config).model.encoder, 6,
                               *kg_schema(dt.kg_node_feats,
                                          dt.kg_edge_indices))
    load_flax_weights(model, v)
    return dict(j_model=j_model, v=v, model=model.train(), kj=kj, kt=kt,
                j_batches={"train": bj, "val": vj},
                t_batches={"train": bt, "val": vt})


@pytest.mark.parametrize("split,eval_types", [
    ("val", None),
    ("val", ["str_full", "full_full", "str+tx_full"]),
    ("train", ["full_full", "str_str", "str_full"])])
def test_evaluate_ft_matches_jax(carried, split, eval_types):
    c = carried
    je = j_evaluate.Evaluator(c["j_model"], "str_random_sample")
    te = t_evaluate.Evaluator(c["model"], "str_random_sample")
    want = je.evaluate_ft(c["v"], c["j_batches"][split], c["kj"], split,
                          eval_types=eval_types)
    got = te.evaluate_ft(c["t_batches"][split], c["kt"], split,
                         eval_types=eval_types)
    assert np.isfinite(want)
    assert abs(got - want) <= 1e-5
    assert sorted(te.best_metrics) == sorted(je.best_metrics)
    assert_metrics_equal(te.best_metrics, {k: je.best_metrics[k]
                                           for k in te.best_metrics}, 1e-5)
    assert c["model"].training  # evaluated in eval mode, then put back


def test_make_predictions_matches_jax(carried):
    c = carried
    for et in ("str_str", "str+tx_full"):
        want = j_predict.make_predictions(
            c["j_model"], c["v"], c["j_batches"]["val"], c["kj"], et,
            "str_random_sample")
        got = t_predict.make_predictions(
            c["model"], c["t_batches"]["val"], c["kt"], et,
            "str_random_sample")
        keep = np.asarray(c["j_batches"]["val"].mask)
        np.testing.assert_allclose(got, want[keep], atol=1e-5, rtol=0)


def test_modality_ablation_study_matches_jax(carried):
    """On the val batch, whose pairs are scored in one direction. (On the
    undirected train batch each pair is scored both ways, and the two
    scores of a symmetric decoder tie exactly or differ by one unit in the
    last place by summation order, in either package; a tie against a
    near-tie moves a label's AP by up to 4e-3.)"""
    c = carried
    combos = [("str",), ("str", "kg"), ("cv", "tx"),
              ("str", "kg", "cv", "tx")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_ablation.modality_ablation_study(
            c["j_model"], c["v"], c["j_batches"]["val"], c["kj"],
            "full_full", combos=combos)
        got = t_ablation.modality_ablation_study(
            c["model"], c["t_batches"]["val"], c["kt"], "full_full",
            combos=combos)
    assert list(got) == list(want)
    for combo in want:
        np.testing.assert_array_equal(got[combo]["labels"],
                                      want[combo]["labels"])
        np.testing.assert_array_equal(got[combo]["pos_samples"],
                                      want[combo]["pos_samples"])
        assert_metrics_equal(got[combo], want[combo], 1e-5)
    assert not np.allclose(np.nan_to_num(got["str"]["auprc"]),
                           np.nan_to_num(got["str+kg+cv+tx"]["auprc"]))


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("label_map", [None, "names"])
def test_save_scores_csv_matches_pandas(tmp_path, label_map):
    rng = np.random.RandomState(5)
    T = 120
    preds = rng.rand(T).astype(np.float32)
    pos_neg = (rng.rand(T) < 0.4).astype(int)
    labels = rng.randint(0, 4, T)
    labels[labels == 3] = 5  # label ids need not be consecutive
    lm = ({i: f"outcome, {i}" for i in (0, 1, 2, 5)} if label_map
          else None)
    paths = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, mod in (("jax", j_evaluate), ("port", t_evaluate)):
            paths[name] = mod.save_scores_and_stratified_metrics(
                preds, pos_neg, labels, str(tmp_path / name), "test",
                "full_full", "str_random_sample", label_map=lm, k=10)
    for want_path, got_path in zip(paths["jax"], paths["port"]):
        assert got_path.replace("port", "jax") == want_path
        want, got = read_csv(want_path), read_csv(got_path)
        assert got[0] == want[0] and len(got) == len(want)
        for gr, wr in zip(got[1:], want[1:]):
            for g, w in zip(gr, wr):
                try:
                    assert float(g) == float(w) or (g == w == "")
                except ValueError:
                    assert g == w
    assert read_csv(paths["port"][1])[0][-2:] == ["pos_samples", "label"]
