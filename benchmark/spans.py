"""The program's spans joined with the device trace of the same process.

The program records spans and counters (`mot3d_tpu_torch/utils/trace.py`)
in Unix-epoch nanoseconds, the clock of torch.profiler's events.  A
kernel or copy belongs to the innermost program span of its process that
was open when the host launched it: the launch is the CUDA API call
(`cudaLaunchKernel`, `cuLaunchKernel`, ...) with the kernel's correlation
id, and the span is chosen by time within the process, not by thread
(autograd's device thread launches the backward kernels while
`train.backward` is open on the caller's thread, which waits in
`backward()`).

`build` turns one process's kernels, their launch times and its drained
records into arrays (microseconds of the shared clock, as `profiling.py`
keeps them); the readers' helpers take a list of such timelines, one a
process: `device_ms` and `launches` (the kernels and copies of a span
with its children), `host_ms` (span durations) and `counter` (a span
counter), each per occurrence of another span (a sequence, a training
step), and None where the span never ran.  `gap_name` renames an idle
gap's `<label>:<op>` to `<label>/<span>:<op>` by the innermost span open
at its midpoint, where one is.

Nothing here reads a profile: the kernels and launch times come from the
pass over the profile's events that `profiling.py` makes.  There the
launch of a kernel is the CUDA API call (`cu*`) with its correlation
id (a CPU op may carry the same number), and a device row of a
`record_function` label (`is_user_annotation()`) is not a kernel."""

from __future__ import annotations

import numpy as np

from benchmark import profiling


def build(device: list, launches: dict, records: list) -> dict:
    """One process's timeline from its device events [(name, start_ns,
    end_ns, correlation)], the host times of its launches {correlation:
    ns} and the program's records (`trace.drain()`)."""
    ids = {r["id"]: i for i, r in enumerate(records)}
    parent = np.array([ids.get(r["parent"], -1) for r in records], np.int64)
    return {
        "dev": np.array([(s / 1e3, e / 1e3) for _, s, e, _ in device],
                        np.float64).reshape(-1, 2),
        "launch": np.array([launches.get(c, np.nan) / 1e3
                            for *_, c in device], np.float64),
        "copy": np.array([profiling.is_copy(n) for n, *_ in device], bool),
        "start": np.array([r["start_ns"] / 1e3 for r in records],
                          np.float64),
        "end": np.array([r["end_ns"] / 1e3 for r in records], np.float64),
        "name": [r["name"] for r in records],
        "parent": parent, "depth": _depth(parent),
        "counts": [r["counts"] for r in records]}


def _depth(parent: np.ndarray) -> np.ndarray:
    depth = np.zeros(len(parent), np.int64)
    for i in range(len(parent)):
        j = parent[i]
        while j >= 0:
            depth[i] += 1
            j = parent[j]
    return depth


def innermost(tl: dict, times: np.ndarray) -> np.ndarray:
    """Index of the innermost span open at each time, or -1 (outside
    every span, or the time is not a number: a launch not found)."""
    owner = np.full(len(times), -1, np.int64)
    order = np.argsort(times)
    sorted_t = times[order]
    # Spans of one thread nest: of those open at a time, the innermost
    # started last (or at the same time, deeper).
    for i in np.lexsort((tl["depth"], tl["start"])):
        lo = np.searchsorted(sorted_t, tl["start"][i], "left")
        hi = np.searchsorted(sorted_t, tl["end"][i], "right")
        owner[order[lo:hi]] = i
    return owner


def _under(tl: dict, name: str) -> np.ndarray:
    """Whether each span is `name` or inside one."""
    under = np.array([n == name for n in tl["name"]], bool)
    for i in np.argsort(tl["depth"], kind="stable"):
        p = tl["parent"][i]
        under[i] |= p >= 0 and under[p]
    return under


def _occurrences(tls: list, name: str) -> int:
    return sum(tl["name"].count(name) for tl in tls)


def _per(tls: list, span: str, per: str, total) -> float | None:
    n = _occurrences(tls, per)
    if not _occurrences(tls, span) or not n:
        return None
    return total / n


def device_ms(tls: list, span: str, per: str) -> float | None:
    """Device milliseconds of the kernels and copies launched inside
    `span` (with its children), per occurrence of `per`."""
    total = 0.0
    for tl in tls:
        owner = innermost(tl, tl["launch"])
        hit = owner >= 0
        hit[hit] = _under(tl, span)[owner[hit]]
        total += float((tl["dev"][hit, 1] - tl["dev"][hit, 0]).sum()) / 1e3
    return _per(tls, span, per, total)


def launches(tls: list, span: str, per: str) -> float | None:
    """Kernels (copies left out) launched inside `span` (with its
    children), per occurrence of `per`."""
    total = 0
    for tl in tls:
        owner = innermost(tl, tl["launch"])
        hit = (owner >= 0) & ~tl["copy"]
        hit[hit] = _under(tl, span)[owner[hit]]
        total += int(hit.sum())
    return _per(tls, span, per, total)


def host_ms(tls: list, span: str, per: str) -> float | None:
    """Host milliseconds inside the spans `span`, per occurrence of
    `per`."""
    total = sum(float(e - s) for tl in tls
                for s, e, n in zip(tl["start"], tl["end"], tl["name"])
                if n == span) / 1e3
    return _per(tls, span, per, total)


def counter(tls: list, name: str, span: str, per: str) -> float | None:
    """The counter `name` of the spans `span`, added up, per occurrence of
    `per`."""
    total = sum(c.get(name, 0) for tl in tls
                for c, n in zip(tl["counts"], tl["name"]) if n == span)
    return _per(tls, span, per, total)


def gap_name(tl: dict, t: float, key: str) -> str:
    """An idle gap's name `<label>:<op>` (the host's state at its midpoint
    `t`, microseconds) with the innermost program span open at `t`
    added: `<label>/<span>:<op>`; unchanged where no span is open."""
    (i,) = innermost(tl, np.array([t], np.float64))
    if i < 0:
        return key
    label, op = key.split(":", 1)
    return f"{label}/{tl['name'][i]}:{op}"
