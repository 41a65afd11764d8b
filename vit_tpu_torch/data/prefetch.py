"""Device prefetch: overlap the host → device copy of batch N+1 with the
step on batch N (counterpart of ``vit_tpu/data/prefetch.py:25``).

``device_prefetch`` keeps ``depth`` prepared batches in flight: ``prepare``
of batch N+1 is issued before batch N is handed out. ``ToDevice`` is the
``prepare`` of the train loops:

  - on a CUDA device each array is copied into a fresh pinned host buffer
    (``pin_memory``: a copy from pageable memory would block the host), then
    ``.to(device, non_blocking=True)`` on a side stream, after which the
    side stream records an event. A fresh buffer per batch means none is
    refilled while its copy runs (PyTorch's pinned allocator keeps a freed
    buffer until the copies that read it end);
  - when the batch is handed out (``wait``), the compute stream waits on
    that event, and each device tensor is marked as used by the compute
    stream (``record_stream``), so the allocator does not hand its memory
    to the side stream's next copy while a step still reads it;
  - on the CPU a batch becomes tensors that share the arrays' memory
    (``torch.from_numpy``), and ``wait`` does nothing.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def device_prefetch(iterable: Iterable, prepare: Callable, depth: int = 2
                    ) -> Iterator:
    """Yield ``prepare(item)`` for each item, with ``prepare`` issued for up
    to ``depth`` items ahead. Where ``prepare`` has a ``wait`` method, each
    prepared item passes through it as it is handed out."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    wait = getattr(prepare, "wait", None)
    queue: deque = deque()
    it = iter(iterable)

    def enqueue(n: int):
        for _ in range(n):
            try:
                item = next(it)
            except StopIteration:
                return
            queue.append(prepare(item))

    enqueue(depth)
    while queue:
        out = queue.popleft()
        enqueue(1)
        yield wait(out) if wait is not None else out


class ToDevice:
    """``prepare`` for ``device_prefetch``: a tuple of numpy arrays → a
    tuple of tensors on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, batch):
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
        if self.stream is None:
            return tuple(host)
        with torch.cuda.stream(self.stream):
            out = tuple(t.pin_memory().to(self.device, non_blocking=True)
                        for t in host)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def wait(self, prepared):
        if self.stream is None:
            return prepared
        out, event = prepared
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for t in out:
            t.record_stream(compute)
        return out
