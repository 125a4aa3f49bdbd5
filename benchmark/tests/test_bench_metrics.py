"""The per-layer readers on a small recorded trace: a profiler window
written as torch.profiler's chrome trace writes it (spans, runtime
launches and device operations sharing correlation ids)."""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

import counting
import harness
import run


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def recorded_trace():
    """A window of 100 us: two K2 calls in their spans (on the autograd
    thread 2; the second runs the narrow first launch and both second
    launches), a cuBLAS GEMM, K1's two kernels and a sort, each launched
    inside the window; one kernel launched before the window."""
    ev = [_x("user_annotation", harness.WINDOW_SPAN, 0, 100),
          _x("user_annotation", "bench.k2#0", 10, 5, tid=2),
          _x("user_annotation", "bench.k2#1", 30, 5, tid=2),
          _x("cpu_op", "aten::mm", 50, 4)]
    launches = [(1, 11, 2), (2, 31, 2), (3, 32, 2), (9, 33, 2), (4, 51, 1),
                (5, 60, 1), (6, 61, 1), (7, 62, 1), (8, -5, 1)]
    for corr, ts, tid in launches:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid, corr))
    ops = [("void segment_sum_kernel<float>(float const*)", 12, 4, 1),
           ("segment_groups_kernel", 32, 2, 2),
           ("segment_combine_kernel", 34, 1, 3),
           ("void (anonymous namespace)::segment_combine_groups_kernel<4>"
            "(float const*)", 35, 3, 9),
           ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n(params)", 52, 20, 4),
           ("(anonymous namespace)::f32::gemm_f32<false, float>", 75, 10, 5),
           ("f32::gemm_f32<true, float>", 85, 5, 6),
           ("at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", 90, 6, 7),
           ("elementwise_kernel", -3, 2, 8)]
    for name, ts, dur, corr in ops:
        ev.append(_x("kernel", name, ts, dur, corr=corr))
    return harness.Trace.from_events(ev)


def context(kind):
    trace = recorded_trace()
    ops = trace.window_ops()
    k2 = {"bench.k2#0": (1000, 10, 128, torch.float32),
          "bench.k2#1": (2000, 10, 4, torch.float32)}
    return trace, harness.LayerContext(
        kind=kind, units=2, window_s=100e-6, untraced_s=80e-6,
        busy_s=trace.busy_us(ops) / 1e6,
        ops=ops, model_ops_per_unit=1e6,
        k1_calls=[(1, 10, 10, torch.float32, torch.float32)],
        k2_calls=k2, k2_ops=trace.ops_by_span("bench.k2#"))


def test_window_and_spans():
    trace, ctx = context("train")
    assert len(ctx.ops) == 8  # the kernel launched before the window is out
    assert ctx.busy_s == pytest.approx(51e-6)  # 4+2+1+3+20+10+5+6
    spans = ctx.k2_ops
    assert [o[0] for o in spans["bench.k2#0"]] == ["segment_sum_kernel<float>"]
    assert len(spans["bench.k2#1"]) == 3
    bd = trace.breakdown(ctx.ops)
    assert bd["device_ops"][0] == ["sm90_xmma_gemm_f32f32_f32f32_f32_nn_n",
                                   pytest.approx(20e-6)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(
        (16 + 14 + 3) * 1e-6)  # the gaps between operations


def test_train_readers():
    _, ctx = context("train")
    want = {
        "train_mfu_pct": 100 * 1e6 * 2 / 80e-6 / 67e12,
        "gemm_ms_per_step": 20e-3 / 2,
        "device_idle_pct.train": 100 * (1 - 51 / 100),
        "k2_roofline_pct": 100 * (counting.k2_bound(1000, 10, 128,
                                                    torch.float32)[0]
                                  + counting.k2_bound(2000, 10, 4,
                                                      torch.float32)[0])
        / 10e-6,
    }
    for name, v in want.items():
        assert run.read_metric(name, ctx) == pytest.approx(v), name
    for name in ("export_mfu_pct", "rank_sort_ms_per_outcome",
                 "device_idle_pct.ranks"):
        assert run.read_metric(name, ctx) is None


def test_rank_readers():
    _, ctx = context("ranks")
    want = {
        "export_mfu_pct": 100 * 1e6 * 2 / 80e-6 / 67e12,
        "k1_roofline_pct": 100 * counting.k1_bound(
            1, 10, 10, torch.float32, torch.float32)[0] / 15e-6,
        "rank_sort_ms_per_outcome": (4 + 2 + 1 + 3 + 20 + 6) * 1e-3 / 2,
        "device_idle_pct.ranks": 100 * (1 - 51 / 100),
    }
    for name, v in want.items():
        assert run.read_metric(name, ctx) == pytest.approx(v), name
    assert run.read_metric("train_mfu_pct", ctx) is None


def test_readers_find_nothing():
    """A window with no device operation reads nothing, never 0."""
    ctx = harness.LayerContext(kind="train", units=2, window_s=1.0,
                               busy_s=0.0, ops=[])
    for name in ("k2_roofline_pct", "device_idle_pct.train"):
        assert run.read_metric(name, ctx) is None
    ctx.kind = "ranks"
    assert run.read_metric("k1_roofline_pct", ctx) is None


CSRC = Path(__file__).resolve().parents[2] / "madrigal_tpu_torch" / "csrc"


def _globals(cu: str) -> list:
    """The names of the `__global__` functions of a .cu file."""
    text = (CSRC / cu).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s*)?(\w+)\s*\(", text)


def _pattern(metric: str):
    path = Path(run.BENCH) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("m_" + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KERNELS


@pytest.mark.parametrize("cu,metric", [("segment_sum.cu", "k2_roofline_pct"),
                                       ("bilinear.cu", "k1_roofline_pct")])
def test_readers_name_every_kernel(cu, metric):
    """A roofline reader sums every kernel its .cu defines, as the trace
    names them (a template's arguments after the name)."""
    names = _globals(cu)
    assert len(names) >= 2, names
    pattern = _pattern(metric)
    for n in names:
        assert pattern.search(n + "<float>"), n
        assert pattern.search("(anonymous namespace)::" + n), n
    assert not pattern.search("segment_reduce_forward_kernel<float>")
