"""On the card: the control of each cell's comparison at the cell's own
size (one seed), which the card alone can give, and in serving the fault
that gives one slot of every frame another detection's heads.  Run on the GPU machine
with `python -m pytest benchmark/tests -q -m gpu`."""

from __future__ import annotations

import pytest
import torch

from benchmark import common, run
from benchmark.calibrate import CONTROL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    common.setup_process()
    from mot3d_tpu_torch.ops.cuda.build import build
    build()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["serve.gn.c4", "serve.d2.c4"])
def test_bench_gpu_serving_control_fails_and_program_holds(card, name):
    from benchmark import calibrate
    c = common.cell(name)
    limits = c["workload"]["limits"]
    seed = 7_000_000_001
    ok, compared = run.judge(calibrate.serve_readings(c, seed, card)[0],
                             limits)
    assert ok, compared
    for plant in (CONTROL, "slot_heads"):
        ok, compared = run.judge(calibrate.serve_readings(
            c, seed, card, plant)[0], limits)
        assert not ok, (plant, compared)


@pytest.mark.gpu
def test_bench_gpu_training_control_fails_and_program_holds(card):
    from benchmark import calibrate
    c = common.cell("train.det.gn.b2")
    limits = c["workload"]["limits"]
    seed = 7_000_000_003
    ok, compared = run.judge(calibrate.train_readings(c, seed, card), limits)
    assert ok, compared
    ok, compared = run.judge(calibrate.train_readings(
        c, seed, card, CONTROL), limits)
    assert not ok, compared
