"""The program's serving step and detection training step against the
plain reference at a tiny width on the CPU, and the bfloat16 control
outside the limits."""

from __future__ import annotations

import pytest

from benchmark.tests.bench_helpers import (serve_control, serve_run,
                                           train_run)


@pytest.mark.parametrize("name,config", [("serve.gn.c4", "r50fpn-gn"),
                                         ("serve.d2.c4", "r50fpn-d2")])
def test_bench_serving_step_matches_reference(name, config):
    ok, compared, readings, res = serve_run(name, config)
    assert ok, compared
    assert readings["posed_per_sequence"] > 0
    assert readings["sequences_checked"] == 2
    assert res["sequences"] > 0 and res["frames_per_s"] > 0


def test_bench_training_step_matches_reference():
    ok, compared, readings, res = train_run()
    assert ok, compared
    assert res["steps"] > 0 and res["train_images_per_s"] > 0


@pytest.mark.parametrize("name,config", [("serve.gn.c4", "r50fpn-gn"),
                                         ("serve.d2.c4", "r50fpn-d2")])
def test_bench_bf16_control_fails_serving(name, config):
    ok, compared, readings = serve_control(name, config)
    assert not ok, compared


def test_bench_bf16_control_fails_training():
    ok, compared, _, _ = train_run(plant="bfloat16")
    assert not ok, compared
