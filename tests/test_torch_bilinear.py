"""Kernel K1 (pair x outcome bilinear scores): the port's plain version
against the JAX package's `bilinear_scores_xla` and its Pallas kernel in
interpret mode. The CUDA kernel is held to the plain version on a card
in `test_torch_cuda.py`.

Tolerances: f32 compute keeps atol/rtol 1e-4 (the same f32 products,
summed in another order). bf16 compute with f32 output is held to 2e-2 of
max|ref|: both sides round the inputs and z_head . W_l to bf16 at the
same points, but a sum taken in another order can land on the other side
of a bf16 rounding boundary, which moves a score by up to one bf16 ulp of
its ZW factor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrigal_tpu.ops.bilinear_pallas import (
    bilinear_scores_pallas,
    bilinear_scores_xla,
)
from madrigal_tpu_torch.ops import bilinear as tb
from test_torch_train import one_thread  # noqa: F401  (fixture)

# (L, M, N): whole tiles; ragged; and one row against the odd serving
# width and a row width with N % 8 == 2, with L not a multiple of the
# bf16 kernel's outcome group
SHAPES = [(3, 256, 1024), (3, 300, 300), (5, 1, 6843), (3, 100, 1002)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(L, M, N, seed=0):
    rng = np.random.RandomState(seed)
    zh = rng.randn(M, 128).astype(np.float32)
    zt = rng.randn(N, 128).astype(np.float32)
    w = (rng.randn(L, 128, 128) / np.sqrt(128)).astype(np.float32)
    return zh, zt, w


def _close(out, ref, compute):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if compute == "f32":
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_plain_matches_xla_and_pallas(shape, compute):
    L, M, N = shape
    zh, zt, w = _inputs(L, M, N)
    jdt, tdt = DTYPES[compute]
    plain = tb.bilinear_scores_plain(
        torch.from_numpy(zh), torch.from_numpy(zt), torch.from_numpy(w),
        out_dtype=torch.float32, compute_dtype=tdt).numpy()
    xla = bilinear_scores_xla(zh, zt, w, out_dtype=jnp.float32,
                              compute_dtype=jdt)
    pallas = bilinear_scores_pallas(zh, zt, w, tile_m=128, tile_n=256,
                                    out_dtype=jnp.float32,
                                    compute_dtype=jdt, interpret=True)
    _close(plain, xla, compute)
    _close(plain, pallas, compute)


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    zh, zt, w = (torch.from_numpy(a) for a in _inputs(2, 5, 7))
    before = tb.bilinear_scores.launches
    out = tb.bilinear_scores(zh, zt, w, out_dtype=torch.float32,
                             compute_dtype=torch.float32)
    assert tb.bilinear_scores.launches == before  # the plain version ran
    torch.testing.assert_close(out, tb.bilinear_scores_plain(
        zh, zt, w, torch.float32, torch.float32), atol=0, rtol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        tb.bilinear_scores(zh.to("meta"), zt.to("meta"), w.to("meta"))
