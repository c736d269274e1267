"""Helpers of the benchmark's CPU tests: a whole run of a tiny cell on the
CPU (the harness's look for a card skipped), judged as `run.py` judges
it, with a fault or control planted where the run builds its step or
its trainer (`faults.py`); the data-parallel cell on 2 gloo ranks."""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from benchmark import run, serve, train
from benchmark.tests import faults
from benchmark.tests.tiny import tiny_cell

SEED = 12_345_678_901


@contextlib.contextmanager
def _patched(module, attr, value):
    saved = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def serve_run(name="serve.gn.c4", config="r50fpn-gn", plant="",
              seconds=1.5, clients=2):
    """(correct, compared, readings, result) of a tiny serving run on the
    CPU, each client's step with `plant` planted."""
    c = tiny_cell(name, config, clients=clients)
    client = (functools.partial(faults.serving_client, plant) if plant
              else serve.client_main)
    with _patched(serve, "client_main", client):
        res = serve.run(c, SEED, seconds, False, device="cpu",
                        t_process=time.perf_counter())
    readings = run.check_serving(res, c["workload"]["check"]["far"])
    ok, compared = run.judge(readings, c["workload"]["limits"])
    return ok, compared, readings, res


def serve_control(name="serve.gn.c4", config="r50fpn-gn"):
    """The serving control on the CPU: the detector in bfloat16, pose and
    graph + MPN as the reference in TF32 (on the CPU: float32, so only
    the detector's numbers move)."""
    from benchmark import calibrate
    c = tiny_cell(name, config)
    readings, _ = calibrate.serve_readings(c, SEED, torch.device("cpu"),
                                           "bfloat16")
    return run.judge(readings, c["workload"]["limits"]) + (readings,)


def train_run(plant=""):
    """(correct, compared, readings, result) of a tiny training run on the
    CPU, its trainer built with `plant` planted."""
    c = tiny_cell("train.det.gn.b2", "r50fpn-gn")
    make = faults.trainer_maker(plant) if plant else train.make_trainer
    with _patched(train, "make_trainer", make):
        res = train.run(c, SEED, 1.0, False, device="cpu",
                        t_process=time.perf_counter())
    ok, compared = run.judge(res["readings"], c["workload"]["limits"])
    return ok, compared, res["readings"], res


DP_CELL = ("train.det.gn.dp4", "r50fpn-gn")


@contextlib.contextmanager
def one_thread():
    """The reference on one host thread, as the ranks and a run's parent
    (`common.setup_process`) compute: on the CPU a convolution's sums then
    run in the same order on both sides."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def train_dp_run(seconds=1.0, ranks=2):
    """(correct, compared, readings, result) of a tiny data-parallel
    training run on the CPU, `ranks` gloo ranks."""
    c = tiny_cell(*DP_CELL, ranks=ranks)
    with one_thread():
        res = train.run(c, SEED, seconds, False, device="cpu",
                        t_process=time.perf_counter())
    ok, compared = run.judge(res["readings"], c["workload"]["limits"])
    return ok, compared, res["readings"], res


def train_dp_planted(plants, ranks=2):
    """[(correct, compared, readings)] of the data-parallel cell's checked
    steps on the CPU for each of `plants` (a fault or control, "" for
    none), every job on the same `ranks` gloo ranks (no window)."""
    from benchmark import calibrate
    c = tiny_cell(*DP_CELL, ranks=ranks)
    runs = [(p, SEED + 7919 * i, p) for i, p in enumerate(plants)]
    with one_thread():
        got = calibrate.dp_train_readings(c, runs, ["cpu"])
    return [run.judge(r, c["workload"]["limits"]) + (r,) for r in got]
