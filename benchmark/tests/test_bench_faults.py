"""A whole run on the CPU with the timed path broken underneath: each
fault a cell can have makes `correct` false."""

from __future__ import annotations

import pytest

from benchmark.tests import faults
from benchmark.tests.bench_helpers import serve_run, train_run


@pytest.mark.parametrize("fault", faults.SERVE)
def test_bench_serving_fault_is_caught(fault):
    ok, compared, _, _ = serve_run(plant=fault, clients=1)
    assert not ok, compared


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_bench_training_fault_is_caught(fault):
    ok, compared, _, _ = train_run(plant=fault)
    assert not ok, compared
