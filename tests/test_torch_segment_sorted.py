"""Kernel K2's plain version, the sorted gather and the source-sorted KG
layout of the port, against the JAX package.

The JAX side is `sorted_segment_sum_mxu` run as its own tests run it on
the CPU, through the Pallas interpreter, and `gather_rows_mxu` and the HGT
on top of it. Tolerances: the plain K2 takes the same f32 sums as the
Pallas kernel in another order (rtol 2e-6, atol 1e-5, the JAX tests'
own); bf16 input is widened to f32 exactly on both sides, so the same
bound holds; the HGT gradients compare whole encoders whose segment
softmaxes also sum in another order (rtol 5e-5 and atol 1e-5 of the
largest gradient of each tensor). The kernel's order of the sums
(`sorted_segment_sum_ordered`, pieces of P rows) is held to the plain
version exactly on small-integer rows, whose f32 sums are exact in any
order. On randn rows its segments are too long for TOL (hundreds of f32
adds in a row drift by about 3e-5 between two orders), so each order is
held to the float64 sum within the rounding bound of
`_within_rounding_bound`, 6u times the root of the squared running sums.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
    lane_group,
    row_alignment,
    segment_starts_np,
    sorted_segment_sum,
    sorted_segment_sum_ordered,
    sorted_segment_sum_plain,
    supports_sorted_segment_sum,
)
from test_torch_train import one_thread  # noqa: F401  (fixture)

TOL = dict(rtol=2e-6, atol=1e-5)
# P as the kernel's source sets it (on the card the wrapper reads it from
# the built library, `segment_sorted.split_rows()`)
P = int(re.search(
    r"constexpr int kSplitRows = (\d+);",
    (Path(t_gather.__file__).parent.parent / "csrc" / "segment_sum.cu")
    .read_text()).group(1))


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


def _within_rounding_bound(got, data, starts, n):
    """Each segment's f32 sum `got` [n, W] against the float64 sum of its
    rows, within 6u * sqrt(sum_k S_k^2) (u = 2^-24, S_k the float64 running
    sums of the segment's rows in row order): an f32 add rounds its result
    S by at most u|S|, and independent roundings give a standard deviation
    of about u / sqrt(3) times that root, so the bound is about 10 of them,
    whichever order the adds take. Read on this file's cases: the kernel's
    order, `index_add_` and the Pallas kernel reach at most 2.5 of the
    root, at 1,027 rows and 128 columns; gamma_L * sum|x| is 60 to 200
    times wider at these lengths. A dropped or doubled piece of randn rows
    is off by about sqrt(P), some 10^5 times the bound."""
    d = np.asarray(data, np.float64)
    exact = np.zeros((n, d.shape[1]))
    root = np.zeros((n, d.shape[1]))
    for i in range(n):
        b, e = max(int(starts[i]), 0), int(starts[i + 1])
        run = np.cumsum(d[b:e], axis=0)
        if len(run):
            exact[i], root[i] = run[-1], np.sqrt((run ** 2).sum(axis=0))
    err = np.abs(np.asarray(got, np.float64) - exact)
    assert (err <= 6 * 2.0 ** -24 * root).all(), (err / root).max()
    return exact


def _rows_of_lengths(lengths, pad, w, seed, ints=False, lead=0):
    """[lead + sum(lengths) + pad, w] rows: segment i holds lengths[i]
    rows after `lead` rows that belong to none, then `pad` rows of
    trailing padding; randn rows, or small integers with `ints`."""
    rng = np.random.RandomState(seed)
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    starts += lead
    e = int(starts[-1]) + pad
    data = (rng.randint(-8, 9, (e, w)) if ints else rng.randn(e, w))
    return data.astype(np.float32), starts


ORDER_CASES = {
    # lengths about P, empty segments, trailing padding
    "about_p": ([P - 1, P, 0, P + 1, 2 * P, 3, 0, 3 * P + 5], 37, 0),
    # one segment holding every row
    "one_segment": ([3 * P + 5], 0, 0),
    # rows before the first segment, which belong to none
    "lead": ([2 * P + 1, 1, P + 2], 5, 11),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
@pytest.mark.parametrize("ints", [False, True])
def test_ordered_matches_plain(case, ints):
    """The kernel's order against the plain version: exactly on
    small-integer rows; on randn rows both within the rounding bound of
    the float64 sums."""
    lengths, pad, lead = ORDER_CASES[case]
    data, starts = _rows_of_lengths(lengths, pad, 7, seed=len(lengths),
                                    ints=ints, lead=lead)
    d, s = torch.from_numpy(data), torch.from_numpy(starts)
    n = len(lengths)
    got = sorted_segment_sum_ordered(d, s, n, P)
    ref = sorted_segment_sum_plain(d, s, n)
    assert got.dtype == torch.float32 and got.shape == (n, 7)
    if ints:
        assert torch.equal(got, ref)
    else:
        for sums in (got, ref):
            _within_rounding_bound(sums.numpy(), data, starts, n)
    for i, length in enumerate(lengths):  # empty segments are zeros
        if length == 0:
            assert not got[i].any()


def test_ordered_is_the_piecewise_sum():
    """One segment of 3P + 5 rows: the result is, bit for bit, the sum of
    its four pieces' partials in ascending order, each partial its rows
    summed one after another from 0."""
    data, starts = _rows_of_lengths([4, 3 * P + 5, 2], 3, 6, seed=1)
    got = sorted_segment_sum_ordered(torch.from_numpy(data),
                                     torch.from_numpy(starts), 3, P)
    b, e = int(starts[1]), int(starts[2])
    partials = []
    for ps in range(b, e, P):
        acc = np.zeros(6, np.float32)
        for t in range(ps, min(ps + P, e)):
            acc = acc + data[t]
        partials.append(acc)
    assert len(partials) == 4
    want = partials[0]
    for p in partials[1:]:
        want = want + p
    assert np.array_equal(got[1].numpy(), want)
    # a segment of at most P rows: the rows summed in order from 0
    want = np.zeros(6, np.float32)
    for t in range(int(starts[0]), int(starts[1])):
        want = want + data[t]
    assert np.array_equal(got[0].numpy(), want)


def test_ordered_matches_pallas_kernel():
    """The kernel's order against the JAX package's Pallas kernel in
    interpret mode, at a shape with a segment of 2P + 3 rows: both within
    the rounding bound of the float64 sums, and within TOL on the
    segments of at most P rows."""
    data, starts = _rows_of_lengths([5, 2 * P + 3, 0, 40, 1], 20, 128,
                                    seed=2)
    want = sorted_segment_sum_mxu(jnp.asarray(data), jnp.asarray(starts), 5)
    got = sorted_segment_sum_ordered(torch.from_numpy(data),
                                     torch.from_numpy(starts), 5, P)
    for sums in (got.numpy(), np.asarray(want)):
        _within_rounding_bound(sums, data, starts, 5)
    short = np.diff(starts) <= P
    np.testing.assert_allclose(got.numpy()[short], np.asarray(want)[short],
                               **TOL)


@st.composite
def _layouts(draw):
    """(starts, rows, P): small P, segment lengths about it (P and P + 1
    among them), empty segments, rows before the first segment, trailing
    padding, and a single segment holding every row."""
    p = draw(st.sampled_from([1, 2, 3, 4, 8]))
    length = st.one_of(st.integers(0, 4 * p + 2),
                       st.sampled_from([0, p, p + 1]))
    lengths = draw(st.lists(length, min_size=1, max_size=12))
    lead = draw(st.integers(0, 2 * p))
    pad = draw(st.integers(0, 2 * p))
    starts = np.concatenate([[0], np.cumsum(lengths)]) + lead
    return starts.astype(np.int32), int(starts[-1]) + pad, p


@settings(max_examples=300, deadline=None)
@given(_layouts())
def test_ordered_matches_plain_on_drawn_layouts(layout):
    """The kernel's order at a small P on drawn layouts (segments of P and
    P + 1 rows and of up to 4P + 2, empty ones, rows before the first,
    trailing padding, one segment holding every row): the sums of the
    plain version exactly on small-integer rows, and zeros for an empty
    segment."""
    starts, rows, p = layout
    n = len(starts) - 1
    data = torch.from_numpy(np.random.RandomState(rows).randint(
        -8, 9, (rows, 3)).astype(np.float32))
    s = torch.from_numpy(starts)
    got = sorted_segment_sum_ordered(data, s, n, p)
    assert torch.equal(got, sorted_segment_sum_plain(data, s, n))
    assert not got[torch.from_numpy(np.diff(starts) == 0)].any()


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


@pytest.mark.parametrize("dtype,align", [
    (dt, a) for dt in (torch.float32, torch.bfloat16, torch.float16)
    for a in (2, 4, 8, 16, 32) if a >= torch.finfo(dt).bits // 8])
def test_lane_group_mapping(dtype, align):
    """The Python mirror of the kernel's mapping of rows to lanes
    (`lane_group`), for W in 1..1024 on rows of `dtype` whose address is
    a multiple of `align` bytes and of no larger power of two: VEC is the
    vector the kernel's dispatch takes on such an address (8 values where
    W % 256 == 0 and the address is a multiple of 8 values' bytes, 4
    where W % 4 == 0 and it is a multiple of 4 values' bytes, else 1); G
    is a power of two of at most 32 lanes whose G * VEC columns cover the
    row, the least such, and 32 wherever a row needs a whole warp; a warp
    takes 32 / G items."""
    elem = torch.finfo(dtype).bits // 8
    address = (1 << 20) + align  # a multiple of align, not of 2 * align
    assert row_alignment(address) == align
    for w in range(1, 1025):
        vec, g = lane_group(w, dtype, address)
        if w % 256 == 0 and address % (8 * elem) == 0:
            assert vec == 8
        elif w % 4 == 0 and address % (4 * elem) == 0:
            assert vec == 4
        else:
            assert vec == 1
        assert g in (1, 2, 4, 8, 16, 32)
        assert 32 % g == 0 and (32 // g) * g == 32  # items a warp
        assert g * vec >= w or g == 32
        assert g == 1 or (g // 2) * vec < w  # the least power of two
        if w >= 32 * vec:
            assert g == 32
        assert lane_group(w, dtype, align) == (vec, g)


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
