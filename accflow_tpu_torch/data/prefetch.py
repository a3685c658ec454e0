"""Host-to-device prefetching, counterpart of accflow_tpu/data/prefetch.py.

`threaded_batches` runs a batch iterator (decode, collate) in a background
thread. `device_prefetch` moves batches to the card ahead of the consumer:
a host thread pins each numpy batch and copies it with non_blocking=True on
a side stream, keeping up to `depth` batches ahead; the consumer's stream
waits on each copy's event before it uses the batch. On the CPU it passes
the batches through unchanged.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_END = object()


class _Failed:
    def __init__(self, exc: BaseException):
        self.exc = exc


def threaded_batches(iterator: Iterable, num_threads: int = 2, buffer: int = 4) -> Iterator:
    """Run `iterator` in a background thread, yielding in order (one
    producer: order matters for determinism). num_threads=0 is a
    pass-through."""
    if num_threads <= 0:
        yield from iterator
        return
    yield from _background(iter(iterator), buffer, lambda item: item)


def _background(it: Iterator, depth: int, prepare) -> Iterator:
    """Yield prepare(item) for each item of `it`, computed up to `depth`
    items ahead in a daemon thread; the thread's errors are raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def producer():
        try:
            for item in it:
                if stop.is_set():
                    return
                q.put(prepare(item))
        except BaseException as e:  # handed to the consumer
            q.put(_Failed(e))
        finally:
            q.put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Failed):
                raise item.exc
            yield item
    finally:
        stop.set()
        while t.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()


def _map(obj, fn):
    """fn applied to every numpy array or tensor in dicts, lists and tuples."""
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(v, fn) for v in obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return fn(obj)
    return obj


def device_prefetch(iterator: Iterable, depth: int = 2, device=None) -> Iterator:
    """Batches of `iterator` (numpy arrays in dicts, lists or tuples; other
    leaves pass as they are) as tensors on `device`, copied up to `depth`
    batches ahead. A CPU device passes the batches through unchanged."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        yield from iterator
        return
    copy_stream = torch.cuda.Stream(device=dev)

    def prepare(batch):
        with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
            host = _map(batch, lambda a: torch.as_tensor(np.ascontiguousarray(a)).pin_memory())
            moved = _map(host, lambda t: t.to(dev, non_blocking=True))
            done = torch.cuda.Event()
            done.record(copy_stream)
        return moved, host, done  # `host` stays referenced until the copy is waited on

    for moved, _host, done in _background(iter(iterator), depth, prepare):
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        # The copies were allocated on the side stream and are used on the
        # consumer's: tell the caching allocator.
        _map(moved, lambda t: t.record_stream(consumer))
        yield moved
