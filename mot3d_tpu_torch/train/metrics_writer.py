"""Structured metric writer (counterpart of
`mot3d_tpu/train/metrics_writer.py`): JSONL + console, with the reference's
scalar names, so runs are comparable.

One writer appends {"step": ..., "split": ..., **scalars} lines to
metrics.jsonl and mirrors them to stdout every `log_every` steps.  The
train step returns its metrics as device tensors; reading one on the host
waits for the step and costs a device-to-host copy, so `write` stages them
and `flush` fetches every staged scalar in one copy, every `log_every`
steps (or on echo, `flush`, `close`).
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Mapping, Tuple

import torch


def _fetch(values: list) -> List[float]:
    """Scalars (tensors on one device, or numbers) -> floats; the tensors
    come over in one stacked copy."""
    idx = [i for i, v in enumerate(values) if isinstance(v, torch.Tensor)]
    out = list(values)
    if idx:
        fetched = torch.stack([values[i].detach().reshape(()).double()
                               for i in idx]).cpu().tolist()
        for i, f in zip(idx, fetched):
            out[i] = f
    return [float(v) for v in out]


class MetricsWriter:
    def __init__(self, output_dir: str, log_every: int = 20):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self.log_every = log_every
        self._f = open(self.path, "a")
        self._t0 = time.time()
        # (step, split, scalars, echo, t) records not fetched yet.
        self._pending: List[Tuple[int, str, Mapping, bool, float]] = []

    def write(self, step: int, scalars: Mapping[str, float],
              split: str = "train", echo: bool | None = None) -> None:
        echo = echo if echo is not None else (step % self.log_every == 0)
        self._pending.append((int(step), split, dict(scalars), echo,
                              round(time.time() - self._t0, 3)))
        if echo or len(self._pending) >= self.log_every:
            self.flush()

    def flush(self) -> None:
        """Write every staged record, its scalars fetched in one copy."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        values = _fetch([v for rec in pending for v in rec[2].values()])
        pos = 0
        for step, split, scalars, echo, t in pending:
            vals = dict(zip(scalars, values[pos:pos + len(scalars)]))
            pos += len(scalars)
            rec = {"step": step, "split": split, "time": t, **vals}
            self._f.write(json.dumps(rec) + "\n")
            if echo:
                body = " ".join(f"{k}={v:.4f}" for k, v in vals.items())
                print(f"[{split} {step}] {body}", flush=True)
        self._f.flush()

    def close(self):
        self.flush()
        self._f.close()
