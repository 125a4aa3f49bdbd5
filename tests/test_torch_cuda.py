"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 with f32 compute and output within 1e-4 of max|plain|
(the same f32 products, summed in another order); with bf16 anywhere,
1e-2 (a bf16 rounding of z_head . W_l or of the score can land on the
other side of its boundary). K2 within 1e-5 of max|plain| (the same f32
sums in another order; bf16 and f16 rows widen to f32 exactly).
"""
import numpy as np
import pytest
import torch

from madrigal_tpu_torch.ops import bilinear as tb
from madrigal_tpu_torch.ops import segment_sorted as ts
from madrigal_tpu_torch.ops.gather import gather_rows_sorted

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}


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


def _sorted_rows(cuda, e, n, w, real, seed):
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.randint(0, n, real))
    ids[ids == n // 2] = n // 2 + 1  # an empty segment
    data = torch.from_numpy(rng.randn(e, w).astype(np.float32)).to(cuda)
    starts = torch.from_numpy(ts.segment_starts_np(ids, n, real)).to(cuda)
    return data, starts


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,w,real", [(1000, 37, 256, 900),
                                        (4096, 1001, 128, 4000),
                                        (300, 5, 384, 300), (0, 3, 256, 0),
                                        (500, 21, 96, 480), (200, 9, 37, 200),
                                        (64, 4, 1, 60)])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("aligned", [True, False])
def test_segment_sum_kernel_matches_plain(cuda, e, n, w, real, dtype,
                                          aligned):
    """Widths taking each of the kernel's vector paths (8, 4 and 1 values
    a lane), and rows that start off the vector alignment (the scalar
    path)."""
    data, starts = _sorted_rows(cuda, e, n, w, real, seed=e + n)
    data = data.to(DTYPES[dtype])
    if not aligned:  # the same rows one element into a larger buffer
        buf = torch.empty(e * w + 1, dtype=data.dtype, device=cuda)
        buf[1:] = data.reshape(-1)
        data = buf[1:].view(e, w)
    before = ts.sorted_segment_sum.launches
    got = ts.sorted_segment_sum(data, starts, n)
    again = ts.sorted_segment_sum(data, starts, n)
    torch.cuda.synchronize()
    assert ts.sorted_segment_sum.launches == before + 2
    assert got.shape == (n, w) and got.dtype == torch.float32
    assert torch.equal(got, again)  # no atomics: the same bits every run
    ref = ts.sorted_segment_sum_plain(data, starts, n)
    err = (got - ref).abs().max().item() if n else 0.0
    assert err <= 1e-5 * max(ref.abs().max().item(), 1.0)


@pytest.mark.cuda
def test_sorted_gather_backward_launches_k2(cuda):
    from madrigal_tpu_torch.data.kg import _src_sort_layout

    rng = np.random.RandomState(1)
    n, e, w = 50, 600, 256
    idx = rng.randint(0, n, e).astype(np.int32)
    order, starts = _src_sort_layout(idx, np.ones(e, bool), n)
    table = torch.randn(n, w, device=cuda, requires_grad=True)
    cot = torch.randn(e, w, device=cuda)
    args = [torch.from_numpy(a).to(cuda) for a in (idx, order, starts)]
    before = ts.sorted_segment_sum.launches
    (gather_rows_sorted(table, *args) * cot).sum().backward()
    torch.cuda.synchronize()
    assert ts.sorted_segment_sum.launches == before + 1
    ref = torch.zeros_like(table).index_add_(0, args[0].long(), cot)
    assert (table.grad - ref).abs().max().item() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_segment_sum_kernel_refuses_what_it_does_not_take(cuda):
    data, starts = _sorted_rows(cuda, 64, 4, 128, 64, seed=2)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        ts.sorted_segment_sum(data.double(), starts, 4)
    with pytest.raises(ValueError, match="int32"):
        ts.sorted_segment_sum(data, starts.long(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ts.sorted_segment_sum(data.t().contiguous().t(), starts, 4)
