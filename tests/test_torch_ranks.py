"""The port's rank normalization (`madrigal_tpu_torch/eval/ranks.py`)
against the JAX package's (`madrigal_tpu/eval/ranks.py`), on the CPU.

The JAX package ranks under jit in every path that exports ranks, where
XLA turns its division by m into a product with float32(1 / m); its
normalized_rank_matrix is compared here as those paths run it, jitted
(called eagerly it divides, and differs by one unit in the last place on
some entries).

  * normalized_rank_matrix on the same scores: identical arrays for
    distinct scores under every (stable, compact) pair, and under ties
    (integer scores) with stable=True, compact None and True.
  * normalized_ranks_for_outcomes / rank_tensor from z and W: the scores
    (the port's through K1's plain version) within 1e-5, then ranks
    identical at every pair whose score lies further than max(1e-5, twice
    the largest score difference) from every other score of its outcome
    (such a pair has every other score on the same side in both packages).
  * ensemble_normalized_ranks on three seeds' rank tensors: identical.
  * the offline float64 path (normalize_scores_offline / _offline_slice):
    identical to the JAX package's copy.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madrigal_tpu.eval import ranks as j_ranks
from madrigal_tpu_torch.eval import ranks as t_ranks
from test_torch_train import one_thread  # noqa: F401  (fixture)

j_rank_matrix = jax.jit(j_ranks.normalized_rank_matrix,
                        static_argnames=("stable", "compact"))


def distinct_scores(rng, n):
    """[n, n] float32 scores with no two equal."""
    return ((rng.permutation(n * n).astype(np.float32).reshape(n, n)
             - n * n / 2) / n)


def sym_weights(rng, L, D):
    """Symmetrized decoder weights at the model's initial scale."""
    w = (rng.randn(L, D, D) / np.sqrt(D)).astype(np.float32)
    return np.triu(w) + np.transpose(np.triu(w, 1), (0, 2, 1))


@pytest.mark.parametrize("n", [5, 130, 300])
@pytest.mark.parametrize("stable,compact", [
    (True, None), (True, True), (True, False),
    (False, None), (False, True), (False, False)])
def test_rank_matrix_matches_jax_for_distinct_scores(n, stable, compact):
    s = distinct_scores(np.random.RandomState(n), n)
    want = np.asarray(j_rank_matrix(
        jnp.asarray(s), stable=stable, compact=compact))
    got = t_ranks.normalized_rank_matrix(torch.from_numpy(s), stable=stable,
                                         compact=compact)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [30, 300])
@pytest.mark.parametrize("compact", [None, True])
def test_rank_matrix_matches_jax_under_ties(n, compact):
    """Integer scores: many ties, ranked by position in row-major or
    tri-tile order; the two orders give different ranks, each equal to
    the JAX package's."""
    s = np.random.RandomState(7).randint(-3, 4, (n, n)).astype(np.float32)
    want = np.asarray(j_rank_matrix(
        jnp.asarray(s), stable=True, compact=compact))
    got = t_ranks.normalized_rank_matrix(torch.from_numpy(s), stable=True,
                                         compact=compact).numpy()
    np.testing.assert_array_equal(got, want)
    if n > t_ranks.TILE:
        other = t_ranks.normalized_rank_matrix(
            torch.from_numpy(s), stable=True, compact=not compact).numpy()
        assert not np.array_equal(other, got)


def test_lower_tri_order_is_the_packing_order():
    """The compact order is that of the JAX package's tri-tile packing:
    the packed flat positions of the strict lower triangle, in order."""
    n = 300
    pos = np.arange(n * n, dtype=np.float32).reshape(n, n)
    packed, _, _ = j_ranks._pack_tri_tiles(jnp.asarray(pos))
    packed = np.asarray(packed)
    r, c = np.divmod(packed[np.isfinite(packed)].astype(np.int64), n)
    want = (r * n + c)[r > c]
    got = t_ranks.lower_tri_order(n, True, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    rows, cols = np.tril_indices(n, -1)
    np.testing.assert_array_equal(
        t_ranks.lower_tri_order(n, False, "cpu").numpy(), rows * n + cols)


def separated(scores: np.ndarray, gap: float) -> np.ndarray:
    """[L, N, N] bool: strict-lower-triangle pairs whose score is further
    than `gap` from every other lower-triangle score of its outcome."""
    L, n, _ = scores.shape
    rows, cols = np.tril_indices(n, -1)
    out = np.zeros(scores.shape, bool)
    for l in range(L):
        v = scores[l][rows, cols].astype(np.float64)
        order = np.argsort(v)
        sv = v[order]
        d = np.diff(sv)
        near = np.minimum(np.r_[np.inf, d], np.r_[d, np.inf])
        ok = np.empty_like(near, dtype=bool)
        ok[order] = near > gap
        out[l][rows, cols] = ok
    return out | out.transpose(0, 2, 1)


def test_scores_and_rank_tensor_match_jax():
    rng = np.random.RandomState(3)
    N, D, L = 24, 16, 5
    z = rng.randn(N, D).astype(np.float32)
    w = sym_weights(rng, L, D)

    s_j = np.stack([np.asarray(j_ranks.score_outcome(
        jnp.asarray(z), jnp.asarray(w[l]))) for l in range(L)])
    s_t = np.stack([t_ranks.score_outcome(
        torch.from_numpy(z), torch.from_numpy(w[l])).numpy()
        for l in range(L)])
    err = np.abs(s_t - s_j).max()
    assert err <= 1e-5
    sep = separated(s_j, max(1e-5, 2 * err))
    assert sep.mean() > 0.9  # the check below covers most pairs

    want = j_ranks.rank_tensor(z, w, chunk=2)
    got = t_ranks.rank_tensor(z, w, chunk=2, device="cpu")
    assert got.shape == (L, N, N) and got.dtype == np.float32
    np.testing.assert_array_equal(got[sep], want[sep])
    block_j = np.asarray(j_ranks.normalized_ranks_for_outcomes(
        jnp.asarray(z), jnp.asarray(w[1:4])))
    block_t = t_ranks.normalized_ranks_for_outcomes(
        torch.from_numpy(z), torch.from_numpy(w[1:4])).numpy()
    np.testing.assert_array_equal(block_t[sep[1:4]], block_j[sep[1:4]])
    np.testing.assert_array_equal(block_t, got[1:4])
    # the normalized-rank layout: symmetric, zero diagonal, the lower
    # triangle a permutation of {1..m} / m, as float32(k) * float32(1 / m)
    m = N * (N - 1) // 2
    rows, cols = np.tril_indices(N, -1)
    levels = ((np.arange(m, dtype=np.float32) + np.float32(1))
              * (np.float32(1) / np.float32(m)))
    for r in got:
        np.testing.assert_array_equal(r, r.T)
        assert (np.diag(r) == 0).all()
        np.testing.assert_array_equal(np.sort(r[rows, cols]), levels)


def test_rank_tensor_into_memmap_and_unstable(tmp_path):
    """rank_tensor streams into an np.memmap; stable=False (the compact
    order) gives the same ranks for distinct scores."""
    rng = np.random.RandomState(4)
    z = rng.randn(20, 8).astype(np.float32)
    w = sym_weights(rng, 3, 8)
    out = np.lib.format.open_memmap(str(tmp_path / "r.npy"), mode="w+",
                                    dtype=np.float32, shape=(3, 20, 20))
    t_ranks.rank_tensor(z, w, chunk=2, out=out, device="cpu")
    out.flush()
    ref = t_ranks.rank_tensor(z, w, chunk=3, stable=False, device="cpu")
    np.testing.assert_array_equal(np.load(str(tmp_path / "r.npy")), ref)


def test_ensemble_normalized_ranks_match_jax():
    rng = np.random.RandomState(5)
    L, N = 3, 20
    seeds = [np.stack([np.asarray(j_rank_matrix(
        jnp.asarray(distinct_scores(rng, N)))) for _ in range(L)])
        for _ in range(3)]
    want = j_ranks.ensemble_normalized_ranks(seeds, chunk=2)
    got = t_ranks.ensemble_normalized_ranks(seeds, chunk=2, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, seeds[0])
    # the re-rank on the device of an already float32 chunk equals the
    # JAX package's normalized_rank_matrices
    g = rng.rand(2, N, N).astype(np.float32)
    np.testing.assert_array_equal(
        t_ranks.normalized_rank_matrices(torch.from_numpy(g)).numpy(),
        np.asarray(j_ranks.normalized_rank_matrices(jnp.asarray(g))))


def test_offline_normalization_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    raw = rng.randn(3, 12, 12).astype(np.float32)
    raw[1] = np.round(raw[1])  # ties
    raw_path = str(tmp_path / "raw.npy")
    np.save(raw_path, raw)
    want = []
    for l in range(3):
        p = str(tmp_path / f"j{l}.npy")
        np.lib.format.open_memmap(p, mode="w+", dtype=np.float32,
                                  shape=raw.shape)
        j_ranks._offline_slice((raw_path, p, l))
        want.append(np.load(p)[l])
    got = t_ranks.normalize_scores_offline(raw_path,
                                           str(tmp_path / "t.npy"),
                                           num_workers=1)
    np.testing.assert_array_equal(np.asarray(got), np.stack(want))
