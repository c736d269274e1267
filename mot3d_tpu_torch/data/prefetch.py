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
from typing import Any, Callable, Iterator, NamedTuple, Optional

import torch

from mot3d_tpu_torch.parallel.mesh import DataMesh, mesh_device, shard_batch
from mot3d_tpu_torch.utils.tree import as_tensor, leaves, tree_map


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


def device_prefetch(batches: Iterator, device=None, buffer_size: int = 2,
                    mesh: Optional[DataMesh] = None) -> Iterator:
    """Yield device-resident copies of `batches` (any tree of numpy arrays
    or tensors), transferred ahead of use.  `device=None` means the GPU, or
    the mesh's device.  With a `mesh` only this rank's rows of each batch
    (`shard_batch`) are copied: the counterpart of the JAX package's
    `sharding=` placement."""
    dev = mesh_device(device, mesh)
    if mesh is not None:
        batches = (shard_batch(mesh, batch) for batch in batches)
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
        for t in leaves(moved):
            t.record_stream(consumer)
        yield moved
