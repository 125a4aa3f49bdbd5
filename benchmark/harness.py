"""What every cell shares: the set-up clock, the comparison's checks,
the profiler window and its reading, and the result line.

A device operation belongs to the host span whose thread launched it
inside that span: the profiler gives the launch (a CUDA runtime call) and
the operation one correlation id. The device's own timestamps are read
only for durations and for the idle gaps, since in some windows they
shift against the host's by milliseconds.
"""
from __future__ import annotations

import contextlib
import json
import math
import sys
import time
from bisect import bisect_right
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import gc
from types import SimpleNamespace

import torch

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "madrigal_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Collect what nothing holds, and give the card's cached blocks back."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def precision(mode: str, device):
    """float32 matmuls in full float32 ('f32') or in TF32 ('tf32', the
    control: on the card the TF32 tensor cores, on the CPU every
    matmul's float32 operands rounded to TF32's 10-bit mantissa in the
    forward)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    mode_ctx = (_Tf32Rounding() if tf32 and torch.device(device).type
                == "cpu" else contextlib.nullcontext())
    try:
        with mode_ctx:
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on a 10-bit mantissa (TF32)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x1000 + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Tf32Rounding(torch.overrides.TorchFunctionMode):
    MATMULS = {torch.matmul, torch.mm, torch.bmm, torch.einsum,
               torch.nn.functional.linear, torch.Tensor.matmul,
               torch.Tensor.__matmul__, torch.addmm, torch.baddbmm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.MATMULS:
            # the rounded value, with the gradient passed straight through
            args = [a + (round_tf32(a.detach()) - a.detach())
                    if isinstance(a, torch.Tensor)
                    and a.dtype == torch.float32 else a for a in args]
        return func(*args, **kwargs)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first
    dot) is one of FORBIDDEN_MODULES, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


class SetupClock:
    """Seconds from the start of the run, by named part."""

    def __init__(self, device):
        self.device = device
        self.t0 = time.perf_counter()
        self.parts: Dict[str, float] = {}

    @contextlib.contextmanager
    def part(self, name: str):
        sync(self.device)
        t = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.parts[name] = (self.parts.get(name, 0.0)
                                + time.perf_counter() - t)

    def total(self) -> float:
        return time.perf_counter() - self.t0


@dataclass
class Check:
    """One number compared with the reference, beside its limit: the run
    is correct only where value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def load_limits(bench_dir: Path, workload: str) -> Dict[str, float]:
    """{number: limit} of a cell, from limits/<workload>.json."""
    path = bench_dir / "limits" / f"{workload}.json"
    with open(path) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


# ------------------------------------------------------------- the trace
def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].removeprefix("void ")[:80]


@dataclass
class Trace:
    """A profiler window read from its chrome trace."""
    spans: list  # (start us, end us, tid, name) of record_function spans
    launches: dict  # correlation id -> (ts us, tid) of the runtime call
    ops: list  # (name, ts us, dur us, correlation) of device operations
    host_ops: dict  # tid -> sorted [(start us, end us, name)] of cpu ops

    @classmethod
    def from_events(cls, events: list) -> "Trace":
        spans, launches, ops, host = [], {}, [], {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat")
            ts, dur = float(e["ts"]), float(e["dur"])
            corr = e.get("args", {}).get("correlation")
            if cat == "user_annotation":
                spans.append((ts, ts + dur, e["tid"], e["name"]))
                host.setdefault(e["tid"], []).append(
                    (ts, ts + dur, e["name"]))
            elif cat == "cpu_op":
                host.setdefault(e["tid"], []).append(
                    (ts, ts + dur, e["name"]))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = (ts, e["tid"])
            elif cat in DEVICE_CATS:
                ops.append((short_name(e["name"]), ts, dur, corr))
        for v in host.values():
            v.sort()
        return cls(spans, launches, ops, host)

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            return cls.from_events(json.load(f)["traceEvents"])

    def window(self):
        found = [s for s in self.spans if s[3] == WINDOW_SPAN]
        if len(found) != 1:
            raise RuntimeError(f"the trace holds {len(found)} windows")
        return found[0]

    def window_ops(self) -> list:
        """Device operations launched inside the window span."""
        t0, t1 = self.window()[:2]
        return [op for op in self.ops
                if op[3] in self.launches
                and t0 <= self.launches[op[3]][0] <= t1]

    def ops_by_span(self, prefix: str) -> Dict[str, list]:
        """{span name: the device operations launched inside it} for the
        spans whose names start with `prefix` (spans of one prefix must
        not nest)."""
        by_tid = {}
        for s in sorted(x for x in self.spans if x[3].startswith(prefix)):
            by_tid.setdefault(s[2], []).append(s)
        starts = {tid: [s[0] for s in v] for tid, v in by_tid.items()}
        out = {s[3]: [] for v in by_tid.values() for s in v}
        for op in self.ops:
            ts, tid = self.launches.get(op[3], (None, None))
            if tid not in by_tid:
                continue
            i = bisect_right(starts[tid], ts) - 1
            if i >= 0 and ts <= by_tid[tid][i][1]:
                out[by_tid[tid][i][3]].append(op)
        return out

    def busy_us(self, ops: list) -> float:
        """Length of the union of the operations' intervals."""
        total, end = 0.0, -math.inf
        for _, ts, dur, _ in sorted(ops, key=lambda o: o[1]):
            if ts + dur <= end:
                continue
            total += ts + dur - max(ts, end)
            end = ts + dur
        return total

    def host_at(self, tid, t: float) -> str:
        """The innermost host span or op on `tid` running at `t`: the
        latest-starting one that contains it (looked for among the 400
        before `t`)."""
        v = self.host_ops.get(tid, [])
        i = bisect_right(v, (t, math.inf, "")) - 1
        for j in range(i, max(i - 400, -1), -1):
            if v[j][1] >= t:
                return v[j][2]
        return "python (no op)"

    def breakdown(self, ops: list) -> dict:
        """The 10 device operations that took most time, and the idle
        time between operations by what the window's thread was doing in
        the middle of each gap, the 10 largest; seconds."""
        by_op = {}
        for name, _, dur, _ in ops:
            by_op[name] = by_op.get(name, 0.0) + dur / 1e6
        tid = self.window()[2]
        gaps, end = {}, None
        for _, ts, dur, _ in sorted(ops, key=lambda o: o[1]):
            if end is not None and ts > end:
                what = self.host_at(tid, (ts + end) / 2)
                gaps[what] = gaps.get(what, 0.0) + (ts - end) / 1e6
            end = ts + dur if end is None else max(end, ts + dur)
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


@contextlib.contextmanager
def profiled(device, path: Path):
    """torch.profiler over the block, its chrome trace written to
    `path` when the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(path))


class LayerContext(SimpleNamespace):
    """What a per-layer metric reader reads. run.py sets `units` (the
    steps or outcomes the traced window completed), `window_s`,
    `untraced_s` (the seconds the same units took just before, with no
    profiler and no span around K2), `busy_s` (the union of the window's
    device operations) and `ops` (name, ts us, dur us, correlation of
    each device operation launched in the window); the cell's runner adds its own fields (its `layer_context`:
    `kind`, the model operations a unit needs, the kernels' calls with
    their shapes). A field no one set reads None."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return None
