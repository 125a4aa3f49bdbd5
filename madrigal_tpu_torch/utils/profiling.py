"""Profiling and tracing (port of `madrigal_tpu/utils/profiling.py`;
reference madrigal/chemcpa/chemCPA/profiling.py:10-64 and its batch-time
meters): `trace()` wraps a region in a `torch.profiler` trace written as
a Chrome trace (chrome://tracing, Perfetto), `span()` names a region of
the port inside it and keeps its times, `StepTimer` times steps to the
end of their device work, and `memory_stats()` reads the card's
allocator.

The port opens a span at each layer boundary (`madrigal.draw`,
`madrigal.forward`, `madrigal.kg_pass`, `madrigal.backward`,
`madrigal.optimizer` in the trainers and the encoder; `madrigal.k1`,
`madrigal.k2` and `madrigal.rank_sort` in the kernels' entry points and
the rank export). A span costs one check of the profiler's flag while no
profiler records; while one does, it is a `record_function` in the trace
and a `SpanRecord` that `recorded()` returns, timed on the host's clock
and, on CUDA, on the card's own.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

# whether a torch.profiler session records on this thread (the autograd
# engine's threads inherit the launching thread's session)
_profiler_on = torch._C._autograd._profiler_enabled


class SpanRecord:
    """One span of a profiler session: `name`; `parent`, the enclosing
    open span on the same thread (a SpanRecord) or None; `host_start`
    and `host_end`, time.perf_counter seconds; `device_ms`, the card's
    milliseconds between the span's two markers on the current stream
    (None on the CPU or before `recorded()` resolves it); `live_bytes`,
    the allocator's allocated bytes at the span's exit (what
    torch.cuda.memory_allocated reads; None on the CPU);
    `attrs`, the call's attributes or None."""
    __slots__ = ("name", "parent", "host_start", "host_end", "device_ms",
                 "live_bytes", "attrs", "_events")

    def __init__(self, name: str, parent: Optional["SpanRecord"] = None,
                 host_start: float = 0.0, host_end: Optional[float] = None,
                 device_ms: Optional[float] = None,
                 live_bytes: Optional[int] = None,
                 attrs: Optional[dict] = None):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.host_start, self.host_end = host_start, host_end
        self.device_ms, self.live_bytes = device_ms, live_bytes
        self._events = None

    def __repr__(self) -> str:
        return (f"SpanRecord({self.name!r}, parent="
                f"{self.parent.name if self.parent else None!r}, "
                f"device_ms={self.device_ms!r})")


class _Recorder:
    """The spans of the newest profiler session, in the order they were
    opened. `stale` is set by a span that finds no profiler recording; the
    next span that finds one starts a new session."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.stale = True
        self.lock = threading.Lock()
        self.open = threading.local()  # each thread's stack of open spans


_RECORDER = _Recorder()


class _Span:
    """A span while a profiler records (see `span`)."""
    __slots__ = ("record", "scope", "stream", "start")

    def __init__(self, name: str):
        self.record = SpanRecord(name)
        self.scope = torch.profiler.record_function(name)
        self.stream = self.start = None

    def __enter__(self):
        rec, r = _RECORDER, self.record
        stack = getattr(rec.open, "stack", None)
        if stack is None:
            stack = rec.open.stack = []
        r.parent = stack[-1] if stack else None
        with rec.lock:
            if rec.stale:
                rec.records, rec.stale = [], False
            rec.records.append(r)
        stack.append(r)
        self.scope.__enter__()
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        r.host_start = time.perf_counter()
        return r

    def __exit__(self, *exc):
        r = self.record
        r.host_end = time.perf_counter()
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            r._events = (self.start, end)
            # torch.cuda.memory_allocated flattens every allocator
            # statistic into a sorted dict, some 0.1 ms of host time; the
            # nested form is built in C++
            r.live_bytes = torch.cuda.memory_stats_as_nested_dict()[
                "allocated_bytes"]["all"]["current"]
        _RECORDER.open.stack.pop()
        return self.scope.__exit__(*exc)


_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span('madrigal.forward') as record: ...`. While no
    torch.profiler session records, the one shared null context (`record`
    None): nothing is allocated or kept. While one does, the region is a
    `record_function(name)` in the trace, two timing events on the
    current CUDA stream (where CUDA is initialized) and a SpanRecord
    (`record`, whose `attrs` the caller may set) kept for `recorded()`.
    The first span of a session drops the records of the last: a session
    is told from the last by a span that found no profiler between them
    (an untraced step) or by the start of `trace`."""
    if not _profiler_on():
        _RECORDER.stale = True
        return _OFF
    return _Span(name)


def recorded() -> List[SpanRecord]:
    """The spans of the newest profiler session in the order they were
    opened, each with its device milliseconds: the card is synchronized
    once and each closed span's event pair read (then let go)."""
    rec = _RECORDER
    with rec.lock:
        out = list(rec.records)
    pending = [r for r in out if r._events is not None]
    if pending:
        torch.cuda.synchronize()
    for r in pending:
        start, end = r._events
        r.device_ms, r._events = start.elapsed_time(end), None
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace('traces') as prof: step()`: a `torch.profiler.profile`
    of the CPU and, when a card is present, of CUDA (CUPTI records every
    kernel launched in the process's context), written on exit to
    `log_dir/trace_<ns>.json`; `prof.key_averages()` gives the sums by
    operation and kernel, and `recorded()` the port's spans inside it
    (those of this trace alone)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _RECORDER.stale = True
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def _cuda_devices(result, out: set) -> set:
    """The CUDA devices of the tensors in `result` (nested lists, tuples
    and dicts)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            out.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _cuda_devices(v, out)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _cuda_devices(v, out)
    return out


class StepTimer:
    """Wall-clock step timing. PyTorch returns before the card has done
    the work it queued, so `stop(result)` first waits for every CUDA
    device that holds a tensor of `result`."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        for dev in _cuda_devices(result, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self) -> dict:
        arr = np.asarray(self.times)
        if not len(arr):
            return {}
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "n": len(arr),
        }


def memory_stats() -> dict:
    """{'cuda:<i>': {'bytes_in_use', 'peak_bytes_in_use'}} for each card,
    from PyTorch's allocator (the reference prints
    torch.cuda.memory_allocated; train_ddi_batch.py:357-360); {} without
    a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        }
    return out
