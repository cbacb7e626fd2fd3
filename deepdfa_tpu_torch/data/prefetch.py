"""Host→device prefetch for training and evaluation streams.

The port of ``deepdfa_tpu/data/prefetch.py``. On a CUDA device a background
thread builds the next batches, copies each one's arrays into pinned host
memory and from there to the card on a side CUDA stream, and records an
event on that stream; the consumer makes its current stream wait for the
event before it uses the batch, so the copy of batch k+1 overlaps the step
on batch k without a host sync. At most ``size`` staged batches wait in the
queue. On the CPU it is a plain iterator: batches are converted one at a
time in the consumer's thread.

Exceptions raised by the producer (e.g. an oversize graph rejected by the
batcher mid-stream, or the ``prefetch.producer_raises`` fault point) are
re-raised in the consumer at the point of ``next()``.
Closing the generator (or leaving its loop early) stops the producer and
joins its thread.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from deepdfa_tpu_torch.data.graphs import BatchedGraphs, to_device
from deepdfa_tpu_torch.resilience import faults

__all__ = ["prefetch_to_device"]

_END = object()


class _ProducerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _map_batch(batch, fn):
    """``batch`` (a segment- or dense-layout batch) with ``fn`` applied to
    every array, the feature dict's values included."""
    from deepdfa_tpu_torch.data.dense import DenseBatch

    cls = DenseBatch if hasattr(batch, "adj") else BatchedGraphs
    return cls(*({k: fn(v) for k, v in field.items()}
                 if isinstance(field, dict) else fn(field)
                 for field in batch))


def _stage(batch, device: torch.device, stream):
    """``batch`` copied to ``device`` on ``stream`` through pinned memory,
    and the event that marks the end of the copy."""
    def put(a):
        host = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
        return host.to(device, non_blocking=True)

    with torch.cuda.stream(stream):
        staged = _map_batch(batch, put)
        event = torch.cuda.Event()
        event.record(stream)
    return staged, event


def _tensors(batch):
    for field in batch:
        if isinstance(field, dict):
            yield from field.values()
        else:
            yield field


def prefetch_to_device(iterator: Iterable[BatchedGraphs], device,
                       size: int = 2) -> Iterator[BatchedGraphs]:
    """Yield the batches of ``iterator`` as tensors on ``device``, staged
    up to ``size`` batches ahead on a CUDA device. ``size <= 0`` or a CPU
    device converts each batch when it is asked for."""
    device = torch.device(device)
    if device.type != "cuda" or size <= 0:
        for batch in iterator:
            faults.raise_if("prefetch.producer_raises")
            yield to_device(batch, device)
        return

    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    stream = torch.cuda.Stream(device=device)

    def _put(item) -> bool:
        # every producer put polls `stop`, so a consumer that left early
        # never strands the thread on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            torch.cuda.set_device(device)
            for batch in iterator:
                # a batcher blowing up mid-stream inside the thread must
                # surface at the consumer's next(), never hang
                faults.raise_if("prefetch.producer_raises")
                if not _put(_stage(batch, device, stream)):
                    return
        except BaseException as e:  # re-raised consumer-side
            _put(_ProducerError(e))
            return
        _put(_END)

    t = threading.Thread(target=produce, daemon=True, name="prefetch_to_device")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            staged, event = item
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for tensor in _tensors(staged):
                # the tensors were allocated on the side stream and are used
                # on this one: keep the allocator from reusing their memory
                # before this stream is done with them
                tensor.record_stream(current)
            yield staged
    finally:
        stop.set()
        t.join(timeout=5.0)
        if t.is_alive():  # pragma: no cover — requires a wedged copy
            warnings.warn("prefetch_to_device producer thread failed to exit "
                          "within 5s", RuntimeWarning, stacklevel=2)
