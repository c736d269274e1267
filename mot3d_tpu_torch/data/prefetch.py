"""Device-side input prefetch: overlap the host->device copy with compute
(counterpart of `mot3d_tpu/data/prefetch.py:device_prefetch`).

On a CUDA device a background thread copies each host batch into pinned
(page-locked) memory and issues its copy to the device with
`non_blocking=True` on a side stream, `buffer_size` batches ahead of the
consumer.  The consumer's stream waits on the event recorded after each
batch's copy, and every device tensor is marked as used on the consumer's
stream (`record_stream`), so the caching allocator does not hand its
memory to the side stream while the consumer still reads it.  The pinned
host buffer of a batch is held until its copy's event has completed.  An
error of the loader or of a copy is re-raised in the consumer.  On the
CPU the batches pass through in order, their numpy leaves as tensors.

`background_iter` is the thread-and-queue pattern both this and
`data/detection_loader.py:iterate_detection_batches` use: closing the
consumer (or dropping it) stops the producer thread, so no thread is left
decoding when the interpreter exits.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch

from mot3d_tpu_torch.device import resolve_device


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map `fn` over the array leaves of nested NamedTuples, tuples, lists
    and dicts (numpy arrays and tensors are leaves; other values stay)."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class _Raised(NamedTuple):
    error: BaseException


def background_iter(produce: Callable[[Callable[[Any], bool]], None],
                    buffer_size: int) -> Iterator:
    """Run `produce(emit)` in a daemon thread and yield what it emits, in
    order, at most `buffer_size` items ahead.  `emit(item)` returns False
    once the consumer has stopped; the producer then returns.  An exception
    of the producer is re-raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    halt = threading.Event()
    done = object()

    def emit(item) -> bool:
        while not halt.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def run():
        try:
            produce(emit)
            emit(done)
        except BaseException as e:  # re-raised in the consumer
            emit(_Raised(e))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, _Raised):
                raise item.error
            yield item
    finally:
        halt.set()
        thread.join(timeout=30)


def device_prefetch(batches: Iterator, device=None,
                    buffer_size: int = 2) -> Iterator:
    """Yield device-resident copies of `batches` (any tree of numpy arrays
    or tensors), transferred ahead of use.  `device=None` means the GPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in batches:
            yield tree_map(lambda x: as_tensor(x).to(dev), batch)
        return

    side = torch.cuda.Stream(device=dev)

    def produce(emit):
        in_flight: collections.deque = collections.deque()
        for batch in batches:
            while in_flight and in_flight[0][0].query():
                in_flight.popleft()            # its copy is done
            host = tree_map(lambda x: as_tensor(x).pin_memory(), batch)
            with torch.cuda.stream(side):
                moved = tree_map(lambda x: x.to(dev, non_blocking=True),
                                 host)
                event = torch.cuda.Event()
                event.record(side)
            in_flight.append((event, host))
            if not emit((moved, event)):
                break
        for event, _ in in_flight:
            event.synchronize()

    for moved, event in background_iter(produce, buffer_size):
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(event)
        for t in _leaves(moved):
            t.record_stream(consumer)
        yield moved
