"""The yardstick's arithmetic against counts made by hand."""
import pytest
import torch

import counting


def test_k1_bound_by_hand():
    # L=2, M=3, N=4, D=128, f32 in and out
    nbytes = (3 * 128 + 4 * 128 + 2 * 128 * 128) * 4 + 2 * 3 * 4 * 4
    ops = 2 * 2 * 3 * 128 * 128 + 2 * 2 * 3 * 4 * 128
    assert counting.k1_ops(2, 3, 4) == ops
    t, by = counting.k1_bound(2, 3, 4, torch.float32, torch.float32)
    assert t == pytest.approx(max(nbytes / 3.35e12, ops / 67e12))
    assert by == "bytes"
    # the rank cell's call: 32 x 6,843 x 6,843 is bound by its operations
    t, by = counting.k1_bound(32, 6843, 6843, torch.float32, torch.float32)
    assert by == "operations"
    assert t == pytest.approx(counting.k1_ops(32, 6843, 6843) / 67e12)
    assert counting.k1_ops(1, 6843, 6843) == pytest.approx(12.21e9,
                                                           rel=1e-3)


def test_k2_bound_by_hand():
    # 10 rows of 4 bf16 values into 3 segments
    nbytes = 10 * 4 * 2 + 3 * 4 * 4 + 4 * 4
    t, by = counting.k2_bound(10, 3, 4, torch.bfloat16)
    assert t == pytest.approx(nbytes / 3.35e12) and by == "bytes"


def test_forward_matmul_ops_by_hand():
    mlp = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 4))
    x = torch.randn(5, 8, requires_grad=True)
    want = 2 * 5 * 8 * 16 + 2 * 5 * 16 * 4
    assert counting.forward_matmul_ops(lambda: mlp(x)) == want
    a, b = torch.randn(3, 4, 5), torch.randn(3, 5, 6)
    assert counting.forward_matmul_ops(
        lambda: torch.einsum("bij,bjk->bik", a, b)) == 2 * 3 * 4 * 5 * 6
    # elementwise work counts nothing
    assert counting.forward_matmul_ops(lambda: (x * 2).exp()) == 0
