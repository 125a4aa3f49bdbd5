"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 compute and output within 1e-4 of max|plain| (the same
f32 products, summed in another order); with bf16 anywhere, 1e-2 (a bf16
rounding of z_head . W_l or of the score can land on the other side of
its boundary).
"""
import numpy as np
import pytest
import torch

from madrigal_tpu_torch.ops import bilinear as tb

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 300, 1000), (2, 1, 7), (3, 64, 64)])
@pytest.mark.parametrize("compute,out", [("f32", "f32"), ("bf16", "bf16"),
                                         ("bf16", "f32"), ("f32", "bf16")])
def test_bilinear_kernel_matches_plain(cuda, shape, compute, out):
    L, M, N = shape
    rng = np.random.RandomState(0)
    zh = torch.from_numpy(rng.randn(M, 128).astype(np.float32)).to(cuda)
    zt = torch.from_numpy(rng.randn(N, 128).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.randn(L, 128, 128) / np.sqrt(128))
                         .astype(np.float32)).to(cuda)
    cdt, odt = DTYPES[compute], DTYPES[out]
    before = tb.bilinear_scores.launches
    got = tb.bilinear_scores(zh, zt, w, out_dtype=odt, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert tb.bilinear_scores.launches == before + 1
    assert got.shape == (L, M, N) and got.dtype == odt
    ref = tb.bilinear_scores_plain(zh, zt, w, out_dtype=odt,
                                   compute_dtype=cdt)
    err = (got.float() - ref.float()).abs().max().item()
    tol = 1e-4 if compute == out == "f32" else 1e-2
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
def test_bilinear_kernel_refuses_what_it_does_not_take(cuda):
    zh = torch.randn(4, 64, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        tb.bilinear_scores(zh, zh, torch.randn(1, 64, 64, device=cuda))
    zh = torch.randn(4, 128, device=cuda)
    with pytest.raises(ValueError, match="compute_dtype"):
        tb.bilinear_scores(zh, zh, torch.randn(1, 128, 128, device=cuda),
                           compute_dtype=torch.float16)
