"""Reading torch.profiler traces of the card: device time and count by
kernel name, and the device's busy time and idle gaps on one timeline
merged from every process that shares the card.  Used only in `--trace
1` runs.

A process's profiler gives its kernels' start and end in the profiler's
clock, which all processes of a machine share; the processes sharing one
card are time-sliced, so a kernel's span can include time in which
another process's kernel ran.  The card is busy where at least one
process has a kernel or a copy in flight: the union of all processes'
device spans, over the window that every process profiled."""

from __future__ import annotations

import bisect
import contextlib
import time

import numpy as np
import torch

# Host ops that are the runtime's, not the program's: a gap is named by the
# innermost op around it that is not one of these.
RUNTIME = ("cuda", "Memcpy", "Memset")


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Profile:
    """A profiled span of one process: start it before a call, stop it
    after one; `summary()` reads it."""

    def __init__(self, labels=()):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.calls = 0
        self.labels = labels

    @staticmethod
    def warm(device):
        """Start and stop the profiler once, in set-up: its first start in
        a process takes seconds."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device=device).add_(1)
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    @property
    def on(self) -> bool:
        return self.prof is not None and self.t1 == 0.0

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """Kernels and copies {name: [count, device seconds]}, the calls
        profiled, and the timeline in the shared clock (us): device spans,
        the host ops (innermost program op and the benchmark's labels) and
        the span the host was profiled."""
        base = self.prof.profiler.kineto_results.trace_start_ns() / 1e3
        cuda = torch.autograd.DeviceType.CUDA
        evs = self.prof.events()
        host_names = {e.name for e in evs if e.device_type != cuda}
        kernels, copies, spans = {}, {}, []
        for e in evs:
            # A record_function label shows on the device's timeline too.
            if e.device_type != cuda or e.name in host_names:
                continue
            table = copies if is_copy(e.name) else kernels
            c = table.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += (e.time_range.end - e.time_range.start) / 1e6
            spans.append((e.time_range.start + base, e.time_range.end + base))
        host = sorted((e.time_range.start + base, e.time_range.end + base,
                       e.name) for e in evs if e.device_type != cuda)
        names = sorted({h[2] for h in host})
        index = {n: i for i, n in enumerate(names)}
        return {"kernels": kernels, "copies": copies, "calls": self.calls,
                "device": np.array(spans, np.float64).reshape(-1, 2),
                "host": (np.array([h[0] for h in host]),
                         np.array([h[1] for h in host]),
                         np.array([index[h[2]] for h in host], np.int32),
                         names),
                "labels": list(self.labels),
                "span": (min(h[0] for h in host), max(h[1] for h in host))}


def _union(spans: np.ndarray, lo: float, hi: float):
    """Busy microseconds of the union of spans clipped to [lo, hi], and
    the gaps between them."""
    spans = np.clip(spans[np.argsort(spans[:, 0])], lo, hi)
    busy, gaps, cur_s, cur_e = 0.0, [], lo, lo
    for s, e in spans:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    return busy, gaps


class _Host:
    """What one process's host was doing at a time: its innermost program
    op and the benchmark's label around it."""

    def __init__(self, summary):
        starts, ends, idx, names = summary["host"]
        labels = set(summary["labels"])
        lab = np.array([names[i] in labels for i in idx], bool)
        self.names = names
        self.l_start, self.l_end, self.l_idx = starts[lab], ends[lab], idx[lab]
        keep = ~lab & np.array([not names[i].startswith(RUNTIME)
                                for i in idx], bool)
        self.starts, self.ends, self.idx = starts[keep], ends[keep], idx[keep]

    def at(self, t: float) -> str:
        j = bisect.bisect_right(self.l_start, t) - 1
        label = (self.names[self.l_idx[j]]
                 if j >= 0 and self.l_end[j] >= t else "outside")
        op = "no op"
        i = bisect.bisect_right(self.starts, t) - 1
        for k in range(i, max(-1, i - 400), -1):
            if self.ends[k] >= t:
                op = self.names[self.idx[k]]
                break
        return f"{label}:{op}"


def merge(summaries: list, top: int = 10) -> dict:
    """The processes' profiles on one timeline: kernels and copies added
    up; the card's busy and window seconds over the span every process
    profiled; the idle gaps' seconds by what the hosts were doing (each
    process's share of a gap under its own "label:op")."""
    out = {"kernels": {}, "copies": {}, "calls": 0}
    for s in summaries:
        for key in ("kernels", "copies"):
            for name, (n, sec) in s[key].items():
                c = out[key].setdefault(name, [0, 0.0])
                c[0] += n
                c[1] += sec
        out["calls"] += s["calls"]
    lo = max(s["span"][0] for s in summaries)
    hi = min(s["span"][1] for s in summaries)
    spans = np.concatenate([s["device"] for s in summaries])
    busy, gaps = _union(spans, lo, hi) if hi > lo else (0.0, [])
    hosts = [_Host(s) for s in summaries]
    named = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        for h in hosts:
            key = h.at(mid)
            named[key] = named.get(key, 0.0) + (g1 - g0) / 1e6 / len(hosts)
    out["busy_s"] = busy / 1e6
    out["window_s"] = max(hi - lo, 0.0) / 1e6
    out["gaps"] = dict(sorted(named.items(), key=lambda kv: -kv[1])[:top])
    return out


@contextlib.contextmanager
def label(name: str, on: bool):
    if on:
        with torch.profiler.record_function(name):
            yield
    else:
        yield


def breakdown(merged: dict, top: int = 10) -> dict:
    ops = sorted(((n, sec) for n, (_, sec) in
                  {**merged["kernels"], **merged["copies"]}.items()),
                 key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:160], sec] for n, sec in ops],
            "idle_gaps": [[n[:160], sec] for n, sec in
                          list(merged["gaps"].items())[:top]]}
