"""Kernel K2's plain version, the sorted gather and the source-sorted KG
layout of the port, against the JAX package.

The JAX side is `sorted_segment_sum_mxu` run as its own tests run it on
the CPU, through the Pallas interpreter, and `gather_rows_mxu` and the HGT
on top of it. Tolerances: the plain K2 takes the same f32 sums as the
Pallas kernel in another order (rtol 2e-6, atol 1e-5, the JAX tests'
own); bf16 input is widened to f32 exactly on both sides, so the same
bound holds; the HGT gradients compare whole encoders whose segment
softmaxes also sum in another order (rtol 5e-5 and atol 1e-5 of the
largest gradient of each tensor).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrigal_tpu.config import HGTConfig as JHGTConfig
from madrigal_tpu.data.kg import _src_sort_layout as j_src_sort_layout
from madrigal_tpu.data.kg import build_kg_batch as j_build_kg_batch
from madrigal_tpu.models.hgt import HGTEncoder as JHGTEncoder
from madrigal_tpu.ops.gather import gather_rows_mxu
from madrigal_tpu.ops.segment_pallas import (
    segment_starts_np as j_segment_starts_np,
    sorted_segment_sum_mxu,
    supports_mxu_segment_sum,
)
from madrigal_tpu_torch.config import HGTConfig
from madrigal_tpu_torch.data.kg import _src_sort_layout, build_kg_batch
from madrigal_tpu_torch.interop.from_flax import flax_to_state_dict
from madrigal_tpu_torch.models.hgt import HGTEncoder
from madrigal_tpu_torch.ops import gather as t_gather
from madrigal_tpu_torch.ops.gather import gather_rows_sorted
from madrigal_tpu_torch.ops.segment_sorted import (
    segment_starts_np,
    sorted_segment_sum,
    sorted_segment_sum_plain,
    supports_sorted_segment_sum,
)

TOL = dict(rtol=2e-6, atol=1e-5)


def _sorted_rows(e, n, w, seed, real=None):
    """Rows sorted by a random segment id (some segments empty), the
    rows past `real` trailing padding."""
    rng = np.random.RandomState(seed)
    real = e if real is None else real
    ids = np.sort(rng.randint(0, n, real)).astype(np.int32)
    ids[ids == n // 2] = n // 2 + 1  # segment n // 2 is empty
    data = rng.randn(e, w).astype(np.float32)
    return data, segment_starts_np(ids, n, total_rows=real)


@pytest.mark.parametrize("e,n,w,real", [
    (512, 5, 128, None), (1024, 37, 256, 900), (700, 300, 128, 650)])
def test_plain_matches_pallas_kernel(e, n, w, real):
    data, starts = _sorted_rows(e, n, w, seed=e + n, real=real)
    assert (np.diff(starts) == 0).any()  # empty segments are covered
    want = sorted_segment_sum_mxu(jnp.asarray(data), jnp.asarray(starts), n)
    got = sorted_segment_sum_plain(torch.from_numpy(data),
                                   torch.from_numpy(starts), n)
    assert got.dtype == torch.float32 and got.shape == (n, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper runs the plain version on the CPU, and launches nothing
    before = sorted_segment_sum.launches
    again = sorted_segment_sum(torch.from_numpy(data),
                               torch.from_numpy(starts), n)
    assert sorted_segment_sum.launches == before
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_plain_bf16_input_sums_in_f32():
    data, starts = _sorted_rows(1024, 40, 128, seed=3, real=1000)
    d16 = jnp.asarray(data).astype(jnp.bfloat16)
    want = sorted_segment_sum_mxu(d16, jnp.asarray(starts), 40)
    t16 = torch.from_numpy(np.array(d16.astype(jnp.float32))).bfloat16()
    got = sorted_segment_sum_plain(t16, torch.from_numpy(starts), 40)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_starts_and_gate_match_jax():
    ids = np.sort(np.random.RandomState(4).randint(0, 9, 50))
    for total in (None, 50, 41):
        np.testing.assert_array_equal(segment_starts_np(ids, 9, total),
                                      j_segment_starts_np(ids, 9, total))
    # the CUDA kernel takes every (dtype, width) the Pallas kernel takes,
    # and also widths that are not a multiple of the TPU's 128 lanes, and
    # f16; neither takes f64
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16),
                    (torch.float64, jnp.float64)):
        for w in (37, 96, 128, 256):
            if supports_mxu_segment_sum(jdt, w):
                assert supports_sorted_segment_sum(dt, w)
            assert supports_sorted_segment_sum(dt, w) == (dt != torch.float64)


def test_wrapper_refuses_other_devices():
    data, starts = _sorted_rows(64, 4, 128, seed=5)
    with pytest.raises(ValueError, match="unsupported device"):
        sorted_segment_sum(torch.from_numpy(data).to("meta"),
                           torch.from_numpy(starts), 4)


def test_gather_rows_sorted_grad_matches_jax():
    rng = np.random.RandomState(6)
    n, e, real, w = 50, 600, 560, 128
    idx = rng.randint(0, n, e).astype(np.int32)
    msk = np.arange(e) < real
    order, starts = _src_sort_layout(idx, msk, n)
    table = rng.randn(n, w).astype(np.float32)
    cot = rng.randn(e, w).astype(np.float32)
    cot[~msk] = 0.0  # masked edges carry no cotangent

    def j_loss(t):
        return jnp.vdot(gather_rows_mxu(t, jnp.asarray(idx),
                                        jnp.asarray(order),
                                        jnp.asarray(starts)),
                        jnp.asarray(cot))

    j_grad = jax.grad(j_loss)(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = gather_rows_sorted(t, torch.from_numpy(idx),
                             torch.from_numpy(order),
                             torch.from_numpy(starts))
    torch.testing.assert_close(out, t.detach()[torch.from_numpy(idx).long()],
                               rtol=0, atol=0)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_grad), **TOL)


def _tiny_kg_arrays(n_drug=9, n_gene=7, seed=0):
    rng = np.random.RandomState(seed)
    feats = {"drug": rng.randn(n_drug, 32).astype(np.float32),
             "gene": rng.randn(n_gene, 32).astype(np.float32)}
    edges = {
        ("drug", "targets", "gene"): np.stack([
            rng.randint(0, n_drug, 23), rng.randint(0, n_gene, 23)]),
        ("gene", "ppi", "gene"): np.stack([
            rng.randint(0, n_gene, 31), rng.randint(0, n_gene, 31)]),
        ("drug", "interacts", "drug"): np.stack([
            rng.randint(0, n_drug, 17), rng.randint(0, n_drug, 17)]),
    }
    return feats, edges, list(range(n_drug))


def test_src_sort_layout_matches_jax():
    feats, edges, drugs = _tiny_kg_arrays()
    kj = j_build_kg_batch(feats, edges, drugs, edge_chunk=0, src_sort=True,
                          sort_edges=True)
    kt = build_kg_batch(feats, edges, drugs, device="cpu", src_sort=True)
    assert set(kt.edge_src_order) == set(kj.edge_src_order) == set(
        kt.edge_src)
    for k in kj.edge_src_order:
        np.testing.assert_array_equal(kt.edge_src_order[k].numpy(),
                                      np.asarray(kj.edge_src_order[k]))
        np.testing.assert_array_equal(kt.edge_src_starts[k].numpy(),
                                      np.asarray(kj.edge_src_starts[k]))
        assert kt.edge_src_order[k].dtype == torch.int32
    rng = np.random.RandomState(1)
    src = rng.randint(0, 6, 40).astype(np.int32)
    msk = rng.rand(40) < 0.7
    for a, b in zip(_src_sort_layout(src, msk, 6),
                    j_src_sort_layout(src, msk, 6)):
        np.testing.assert_array_equal(a, b)
    assert not build_kg_batch(feats, edges, drugs,
                              device="cpu").edge_src_order
    # in the input's edge order (no sort_edges on either side) too
    kj = j_build_kg_batch(feats, edges, drugs, edge_chunk=0, src_sort=True)
    kt = build_kg_batch(feats, edges, drugs, device="cpu", src_sort=True,
                        sort_edges=False)
    for k in kj.edge_src_order:
        np.testing.assert_array_equal(kt.edge_src_order[k].numpy(),
                                      np.asarray(kj.edge_src_order[k]))
        np.testing.assert_array_equal(kt.edge_src_starts[k].numpy(),
                                      np.asarray(kj.edge_src_starts[k]))


@pytest.mark.parametrize("scope,hidden", [("per_edge_type", 64),
                                          ("global", 64),
                                          ("per_edge_type", 48)])
def test_hgt_grads_with_src_sort_match_jax(scope, hidden, monkeypatch):
    """The port's HGT takes the sorted backward of its source gather (the
    plain K2 on the CPU) once per layer and edge type, at every width: hidden 64 gives a fused
    k|v table 128 wide, which the JAX package's Pallas kernel also takes;
    hidden 48 gives 96, where JAX keeps the plain gather and the gradients
    are the same."""
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return sorted_segment_sum(*args)

    monkeypatch.setattr(t_gather, "sorted_segment_sum", counted)
    feats, edges, drugs = _tiny_kg_arrays()
    kw = dict(hidden_dim=hidden, num_layers=2, att_heads=4,
              softmax_scope=scope)
    kj = j_build_kg_batch(feats, edges, drugs, edge_chunk=0, src_sort=True)
    kt = build_kg_batch(feats, edges, drugs, device="cpu", src_sort=True)
    jm = JHGTEncoder(cfg=JHGTConfig(**kw), embed_dim=16)
    v = jm.init(jax.random.PRNGKey(0), kj)

    def j_loss(p):
        return sum(jnp.sum(o ** 2) for o in jm.apply(p, kj).values())

    j_val, j_grads = jax.value_and_grad(j_loss)(v)
    tm = HGTEncoder(HGTConfig(**kw), 16, {"drug": 32, "gene": 32},
                    tuple(sorted(edges)))
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    launches = sorted_segment_sum.launches
    t_val = sum((o ** 2).sum() for o in tm(kt).values())
    t_val.backward()
    assert sorted_segment_sum.launches == launches  # CPU: plain version
    # the fused k|v table's transposes (the destination gathers and the
    # softmax denominators' transposes run K2 too, at their widths)
    widths = [shape[1] for shape in calls]
    assert widths.count(2 * hidden) == 2 * len(edges)
    assert set(widths) <= {2 * hidden, hidden, 4}
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-5)
    want = flax_to_state_dict(j_grads)
    for name, p in tm.named_parameters():
        g, ref = p.grad.numpy(), want[name].numpy()
        scale = np.abs(ref).max()
        np.testing.assert_allclose(g, ref, rtol=5e-5, atol=1e-5 * scale,
                                   err_msg=name)
