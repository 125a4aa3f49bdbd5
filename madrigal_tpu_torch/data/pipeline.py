"""Host -> device input pipeline (port of `madrigal_tpu/data/pipeline.py`).

The reference's DataLoader workers (reference: madrigal/parse_args.py:109
num_workers; collators run on the CPU) become a prefetch thread: it
builds batch t+1 on the host while the card runs step t. On CUDA each
batch's tensors go through pinned host memory and a `non_blocking` copy
on a side stream; the consumer's stream waits on an event recorded after
the copy, and `record_stream` keeps the device buffers alive for the
consumer's work. A batch is any nesting of dataclasses, dicts, lists and
tuples of numpy arrays and CPU tensors; other leaves pass through. The
batches equal the ones a serial loop moves with `to_device`, bit for bit.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], obj):
    """`obj` with `fn` applied to each tensor leaf (numpy arrays become
    tensors first)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, np.ndarray):
        return fn(torch.from_numpy(np.ascontiguousarray(obj)))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


def to_device(obj, device: torch.device):
    """A host batch on `device`, copied synchronously (the serial loop)."""
    return map_tensors(lambda t: t.to(device), obj)


class DevicePrefetcher:
    """Wrap a host-batch iterator; yields batches on `device` (None: the
    card) with up to `buffer_size` batches built ahead. An exception in
    the worker is raised to the consumer after the batches before it."""

    def __init__(self, host_iter: Iterable, buffer_size: int = 2,
                 device: Optional[torch.device | str] = None):
        self.device = resolve_device(device)
        self._iter = iter(host_iter)
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _transfer(self, batch):
        if self._stream is None:
            return to_device(batch, self.device), None
        with torch.cuda.stream(self._stream):
            # the caching host allocator keeps each pinned buffer until
            # its copy has run
            out = map_tensors(lambda t: t.pin_memory().to(
                self.device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self):
        try:
            for batch in self._iter:
                self._q.put(self._transfer(batch))
        except BaseException as e:  # raised to the consumer
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._done:
                self._thread.join()
                if self._err is not None:
                    raise self._err
                return
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                map_tensors(lambda t: t.record_stream(stream), batch)
            yield batch


def prefetch_epochs(make_batch: Callable[[int], object], num_steps: int,
                    buffer_size: int = 2,
                    device: Optional[torch.device | str] = None
                    ) -> Iterator:
    """`make_batch(step)` for step in range(num_steps), prefetched onto
    `device`."""

    def gen():
        for step in range(num_steps):
            yield make_batch(step)

    return iter(DevicePrefetcher(gen(), buffer_size, device))
