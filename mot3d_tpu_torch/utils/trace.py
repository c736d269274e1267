"""The program's one recorder of spans and counters.

    from mot3d_tpu_torch.utils import trace
    with trace.span("detect"):
        ...
    trace.count("h2d_bytes", n)

Off (the default), `span` returns one shared no-op after a single check
of the flag: no allocation, no CUDA event, no profiler range and no
synchronise, so an untraced run pays one function call a span.  On
(`enable()`), each span records its name, an id, its parent span's id
and its start and end in Unix-epoch nanoseconds, the clock of
`torch.profiler`'s events (`kineto_results.trace_start_ns()` and each
event's `start_ns()`), so the program's spans and a device trace share
one timeline.  Every span of one served sequence has the sequence's
span `sequence` as its ancestor.  `count` adds to the innermost open
span.  Records stay in memory until `drain()`.

The times are host times: a span ends when the host leaves it, not when
the device has run what the host queued inside it.  Spans are opened from
one thread; kernels that autograd's device thread launches while a span
of the caller's thread is open belong to that span by time alone.
"""

from __future__ import annotations

import contextlib
import time

on = False          # read it; set it with enable() and disable()
_OFF = contextlib.nullcontext()
_open: list = []
_records: list = []
_next_id = 0
_offset_ns = 0


class _Span:
    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts: dict = {}

    def __enter__(self):
        global _next_id
        self.id = _next_id
        _next_id += 1
        self.parent = _open[-1].id if _open else None
        _open.append(self)
        self.start_ns = time.perf_counter_ns() + _offset_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns() + _offset_ns
        _open.pop()
        _records.append({"name": self.name, "id": self.id,
                         "parent": self.parent, "start_ns": self.start_ns,
                         "end_ns": self.end_ns, "counts": self.counts})
        return False


def span(name: str):
    """A context manager that records `name` while tracing is on, else the
    shared no-op."""
    if not on:
        return _OFF
    return _Span(name)


def count(name: str, n) -> None:
    """Add `n` to the counter `name` of the innermost open span."""
    if on and _open:
        counts = _open[-1].counts
        counts[name] = counts.get(name, 0) + n


def enable() -> None:
    """Start recording; the offset from the host's performance counter to
    Unix-epoch nanoseconds is taken now."""
    global on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    on = True


def disable() -> None:
    """Stop recording new spans (spans already open still end)."""
    global on
    on = False


def drain() -> list:
    """The records of every span ended since the last drain, in the order
    they ended, and forget them."""
    global _records
    out, _records = _records, []
    return out
