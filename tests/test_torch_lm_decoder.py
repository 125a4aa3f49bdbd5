"""The LM decoder in the port against the JAX package.

  * `LMDecoder`'s forward with the flax module's weights (carried with
    `interop/from_flax.lm_decoder_state_dict`), self-attention on and off,
    normalize on and off, within 1e-5.
  * 3 Adam steps of `LMDecoderTrainer` on the same fixed batches, with
    'bce' and with `pos_weight`, dropout 0: losses within 1e-5 relative,
    weights within 1e-5, with Adam's allowance (2 * lr * steps) on entries
    whose first gradient is rounding noise (the attention key bias, which
    the softmax cancels).
  * `split_by_outcome_classes` and `build_lm_table` exactly equal to the
    JAX ones (an EdgeTable against the DataFrame), with `eval_frac=0` and
    a table whose negatives cannot all be drawn.
  * `predict` and `evaluate` with equal weights within 1e-6, for a plain
    table and a paraphrase bank; the out-of-range ids raise.
  * The paraphrase draw (a `torch.Generator`'s, not `jax.random`'s) by
    its invariants: every row one of its outcome's variants, every
    variant drawn, and a 1-variant bank trains as the plain table does.
  * `build_paraphrase_bank` with a stub `embed_fn` equals the JAX one.
  * Both CLIs on `--synthetic` with `--drug_embeddings` and
    `--text_embeddings` files: the same `lm_meta.json` label lists and
    width; the port's saved head reloads and scores as trained.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from madrigal_tpu.cli import train_lm as j_cli
from madrigal_tpu.models import lm_decoder as j_lm
from madrigal_tpu.train import lm_decoder as j_train
from madrigal_tpu_torch.cli import train_lm as t_cli
from madrigal_tpu_torch.data.synthetic import EdgeTable
from madrigal_tpu_torch.interop.from_flax import lm_decoder_state_dict
from madrigal_tpu_torch.models import lm_decoder as t_lm
from madrigal_tpu_torch.train import lm_decoder as t_train

DRUGS, LABELS, DRUG_DIM, LM_DIM = 12, 6, 8, 16
WIDTHS = dict(project_dim=8, mlp_dim=16, num_heads=2)
LR, STEPS, BATCH = 1e-2, 3, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def tables(seed=0, variants=0):
    rng = np.random.RandomState(seed)
    drug = rng.randn(DRUGS, DRUG_DIM).astype(np.float32)
    shape = (variants, LABELS, LM_DIM) if variants else (LABELS, LM_DIM)
    return drug, rng.randn(*shape).astype(np.float32)


def batches(seed=1, n=STEPS):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, DRUGS, BATCH), rng.randint(0, DRUGS, BATCH),
             rng.randint(0, LABELS, BATCH),
             (rng.rand(BATCH) < 0.5).astype(np.float32)) for _ in range(n)]


def edges(rng, n=80):
    return {"head": rng.randint(0, DRUGS, n), "tail": rng.randint(0, DRUGS, n),
            "label_indexed": rng.randint(0, LABELS, n)}


# --------------------------------------------------------------- forward
@pytest.mark.parametrize("self_att", [True, False])
@pytest.mark.parametrize("normalize", [False, True])
def test_forward_matches_flax(self_att, normalize):
    rng = np.random.RandomState(2)
    zh, zt = (rng.randn(5, DRUG_DIM).astype(np.float32) for _ in range(2))
    text = rng.randn(5, LM_DIM).astype(np.float32)
    kw = dict(lm_emb_dim=LM_DIM, drug_dim=DRUG_DIM, self_att=self_att,
              normalize=normalize, **WIDTHS)
    jm = j_lm.LMDecoder(**kw)
    params = jm.init(jax.random.PRNGKey(3), zh, zt, text)["params"]
    want = np.asarray(jm.apply({"params": params}, zh, zt, text))
    tm = t_lm.LMDecoder(**kw).eval()
    sd = lm_decoder_state_dict(np_params(params))
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (zh, zt, text))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = t_lm.LMDecoder.from_state_dict(sd, num_heads=2,
                                          normalize=normalize)
    assert back.self_att == self_att and not back.training
    with torch.no_grad():
        np.testing.assert_array_equal(
            back(*(torch.from_numpy(a) for a in (zh, zt, text))).numpy(),
            got)


# ------------------------------------------------------------------ steps
def trainers(pos_weight=None, variants=0, **kw):
    drug, text = tables(variants=variants)
    jt = j_train.LMDecoderTrainer(drug, text, dropout=0.0, lr=LR,
                                  pos_weight=pos_weight, **WIDTHS, **kw)
    tt = t_train.LMDecoderTrainer(drug, text, dropout=0.0, lr=LR,
                                  pos_weight=pos_weight, device="cpu",
                                  **WIDTHS, **kw)
    tt.model.load_state_dict(lm_decoder_state_dict(np_params(
        jt.state.params)))
    return jt, tt


@pytest.mark.parametrize("pos_weight", [None, 3.0])
def test_three_adam_steps_match_jax(pos_weight):
    jt, tt = trainers(pos_weight)
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    lj, lt, grads = [], [], {}
    for b in batches():
        jt.state, loss = jt._step(jt.state, *(jnp.asarray(a) for a in b),
                                  jax.random.PRNGKey(0))
        lj.append(float(loss))
        lt.append(float(tt.train_step(*b)))
        for k, p in tt.model.named_parameters():
            grads.setdefault(k, p.grad.clone())
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    want = lm_decoder_state_dict(np_params(jt.state.params))
    got = tt.model.state_dict()
    assert want.keys() == got.keys()
    top = max(float(g.abs().max()) for g in grads.values())
    for k, ref in want.items():
        noise = (grads[k].abs() <= 1e-6 * top).numpy()
        atol = np.where(noise, 1e-5 + 2 * LR * STEPS, 1e-5)
        err = np.abs(got[k].numpy() - ref.numpy())
        assert (err <= atol).all(), (k, float(err.max()))
        # Adam moves every entry with a real gradient by about lr a step
        if not noise.all():
            assert float((ref - before[k]).abs().max()) > 1e-3, k


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("eval_frac", [0.0, 0.3])
def test_split_and_table_match_jax(eval_frac):
    cols = edges(np.random.RandomState(4))
    jtr, jev, jtl, jel = j_train.split_by_outcome_classes(
        pd.DataFrame(cols), eval_frac=eval_frac, seed=1)
    ttr, tev, ttl, tel = t_train.split_by_outcome_classes(
        EdgeTable(cols), eval_frac=eval_frac, seed=1)
    np.testing.assert_array_equal(ttl, jtl)
    np.testing.assert_array_equal(tel, jel)
    assert (len(tel) == 0) == (eval_frac == 0)
    for t, j in ((ttr, jtr), (tev, jev)):
        assert t.columns == list(j.columns)
        for c in t.columns:
            np.testing.assert_array_equal(t[c], j[c].values)
        for neg in (1, 2):
            want = j_train.build_lm_table(j, DRUGS, neg, seed=5)
            got = t_train.build_lm_table(t, DRUGS, neg, seed=5)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype


def test_unresolvable_negatives_match_jax():
    """Drug 0 pairs with every other drug under outcome 0: its rows get
    no negative, in both packages."""
    cols = {"head": np.array([0, 0, 0, 1]), "tail": np.array([1, 2, 3, 2]),
            "label_indexed": np.array([0, 0, 0, 1])}
    want = j_train.build_lm_table(pd.DataFrame(cols), 4, 2, seed=0)
    got = t_train.build_lm_table(EdgeTable(cols), 4, 2, seed=0)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["pos_neg"] == 0).sum() == 2  # only drug 1's row gets them


# --------------------------------------------------------- predict, evaluate
@pytest.mark.parametrize("variants", [0, 3])
def test_predict_and_evaluate_match_jax(variants):
    jt, tt = trainers(variants=variants)
    table = t_train.build_lm_table(
        EdgeTable(edges(np.random.RandomState(6))), DRUGS, 1, seed=2)
    for v in ([None, 2] if variants else [None]):
        np.testing.assert_allclose(tt.predict(table, variant=v, batch_size=7),
                                   jt.predict(table, variant=v), atol=1e-6)
    want, got = jt.evaluate(table, k=10), tt.evaluate(table, k=10)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], atol=1e-6)
    for col, bad in (("label", LABELS), ("tail", -1)):
        with pytest.raises(ValueError, match=col):
            tt.evaluate({**table, col: np.full_like(table[col], bad)})


def test_paraphrase_draw_invariants():
    drug, bank4 = tables(variants=4)
    tt = t_train.LMDecoderTrainer(drug, bank4, dropout=0.0, device="cpu",
                                  **WIDTHS)
    label = torch.from_numpy(np.random.RandomState(7).randint(
        0, LABELS, 400))
    rows = tt.train_texts(label)
    # each row equals one of its outcome's variants
    match = (rows[:, None, :] == tt.text_table[:, label].transpose(0, 1)
             ).all(-1)
    assert (match.sum(1) == 1).all()
    assert set(match.int().argmax(1).tolist()) == {0, 1, 2, 3}
    # a 1-variant bank trains as the plain table
    drug, text = tables()
    plain = t_train.LMDecoderTrainer(drug, text, dropout=0.0, lr=LR,
                                     device="cpu", **WIDTHS)
    bank = t_train.LMDecoderTrainer(drug, text[None], dropout=0.0, lr=LR,
                                    device="cpu", **WIDTHS)
    for b in batches():
        assert torch.equal(plain.train_step(*b), bank.train_step(*b))
    for k, v in plain.model.state_dict().items():
        assert torch.equal(bank.model.state_dict()[k], v)


def test_build_paraphrase_bank_matches_jax():
    def fake_embed(texts):
        return np.stack([np.frombuffer(t.encode().ljust(48)[:48], np.uint8)
                         .astype(np.float32) for t in texts])

    texts = ["nausea", "headache", "qt prolongation"]
    for n in (1, 4, 12):
        np.testing.assert_array_equal(
            t_lm.build_paraphrase_bank(texts, n, embed_fn=fake_embed),
            j_lm.build_paraphrase_bank(texts, n, embed_fn=fake_embed))
    assert t_lm.PARAPHRASE_TEMPLATES == j_lm.PARAPHRASE_TEMPLATES
    with pytest.raises(RuntimeError, match="local weights"):
        t_lm.extract_text_embeddings(["x"], "no/such-model")


# ---------------------------------------------------------------- the CLIs
def test_train_lm_clis_match_jax(tmp_path):
    rng = np.random.RandomState(8)
    drug_path, text_path = tmp_path / "z.npy", tmp_path / "bank.npy"
    np.save(drug_path, rng.randn(16, DRUG_DIM).astype(np.float32))
    np.save(text_path, rng.randn(2, 8, LM_DIM).astype(np.float32))
    argv = ["--synthetic", "--synthetic_drugs", "16", "--synthetic_labels",
            "8", "--synthetic_edges", "60", "--num_epochs", "2",
            "--batch_size", "32", "--project_dim", "8", "--mlp_dim", "16",
            "--drug_embeddings", str(drug_path), "--text_embeddings",
            str(text_path), "--seed", "3", "--platform", "cpu"]
    j_cli.main(argv + ["--save_dir", str(tmp_path / "j")])
    res = t_cli.main(argv + ["--save_dir", str(tmp_path / "t")])
    meta = {}
    for name in ("j", "t"):
        with open(tmp_path / name / "lm_decoder" / "lm_meta.json") as f:
            meta[name] = json.load(f)
    for key in ("eval_labels", "train_labels", "lm_dim"):
        assert meta["t"][key] == meta["j"][key]
    assert meta["t"]["lm_dim"] == LM_DIM and meta["t"]["eval_labels"]
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    # the saved head, reloaded, scores the eval table as the last epoch did
    sd = torch.load(tmp_path / "t" / "lm_decoder" / "lm_decoder.pt",
                    weights_only=True)
    fresh = t_train.LMDecoderTrainer(np.load(drug_path), np.load(text_path),
                                     project_dim=8, mlp_dim=16, device="cpu")
    fresh.model.load_state_dict(sd)
    assert fresh.evaluate(res["eval_table"]) == res["metrics"][-1]
    back = t_lm.LMDecoder.from_state_dict(sd)
    assert back.text_project.in_features == LM_DIM and back.self_att
