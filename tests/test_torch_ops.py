"""The port's segment ops against madrigal_tpu.ops.segment, including
empty segments, out-of-range (padding) ids and masked edges. atol 1e-6:
the same f32 sums, taken in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrigal_tpu.ops import segment as js
from madrigal_tpu_torch.ops import segment as ts

N = 7  # segments 2 and 6 get no rows


@pytest.fixture
def data():
    rng = np.random.RandomState(0)
    ids = rng.choice([0, 1, 3, 4, 5], size=40).astype(np.int32)
    ids[-5:] = N  # padding rows carry the sentinel id
    x = rng.randn(40, 3).astype(np.float32)
    logits = (rng.randn(40, 4) * 3).astype(np.float32)
    mask = rng.rand(40) < 0.7
    mask[ids == 4] = False  # segment 4: every member masked
    return ids, x, logits, mask


def close(j, t, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["segment_sum", "segment_mean"])
def test_segment_sum_mean(data, name):
    ids, x, _, _ = data
    close(getattr(js, name)(jnp.asarray(x), jnp.asarray(ids), N),
          getattr(ts, name)(torch.from_numpy(x), torch.from_numpy(ids), N))


def test_segment_max_empty_is_neg_inf(data):
    ids, x, _, _ = data
    j = np.asarray(js.segment_max(jnp.asarray(x), jnp.asarray(ids), N))
    t = ts.segment_max(torch.from_numpy(x), torch.from_numpy(ids), N).numpy()
    assert np.isneginf(t[[2, 6]]).all()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("use_mask", [False, True])
def test_segment_softmax(data, use_mask):
    ids, _, logits, mask = data
    jm = jnp.asarray(mask) if use_mask else None
    tm = torch.from_numpy(mask) if use_mask else None
    j = js.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), N, mask=jm)
    t = ts.segment_softmax(torch.from_numpy(logits), torch.from_numpy(ids),
                           N, mask=tm)
    real = ids < N  # padding rows' weights are never read
    assert np.isfinite(t.numpy()).all()
    np.testing.assert_allclose(t.numpy()[real], np.asarray(j)[real],
                               atol=1e-6, rtol=0)
    if use_mask:
        assert (t.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("name", ["masked_mean_pool", "masked_max_pool"])
def test_masked_pools(name):
    rng = np.random.RandomState(1)
    tok = rng.randn(5, 6, 4).astype(np.float32)
    keep = rng.rand(5, 6) < 0.5
    keep[2] = False  # one row keeps nothing
    close(getattr(js, name)(jnp.asarray(tok), jnp.asarray(keep)),
          getattr(ts, name)(torch.from_numpy(tok), torch.from_numpy(keep)))
