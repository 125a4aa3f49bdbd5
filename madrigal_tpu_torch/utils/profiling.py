"""Profiling and tracing (port of `madrigal_tpu/utils/profiling.py`;
reference madrigal/chemcpa/chemCPA/profiling.py:10-64 and its batch-time
meters): `trace()` wraps a region in a `torch.profiler` trace written as
a Chrome trace (chrome://tracing, Perfetto), `annotate()` names a region
inside it, `StepTimer` times steps to the end of their device work, and
`memory_stats()` reads the card's allocator.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace('traces') as prof: step()`: a `torch.profiler.profile`
    of the CPU and, when a card is present, of CUDA (CUPTI records every
    kernel launched in the process's context), written on exit to
    `log_dir/trace_<ns>.json`; `prof.key_averages()` gives the sums by
    operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (shows up on the timeline)."""
    with torch.profiler.record_function(name):
        yield


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
