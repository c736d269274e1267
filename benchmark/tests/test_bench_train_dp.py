"""The data-parallel training cell on the CPU at the tiny sizes, 2 gloo
ranks: the ranks agree on their steps, the reference's averaged step
follows the program's, and the bfloat16 control and every fault such a
cell can have make `correct` false."""

from __future__ import annotations

import pytest
import torch

from benchmark import train_dp
from benchmark.tests import faults
from benchmark.tests.bench_helpers import (DP_CELL, SEED, one_thread,
                                           train_dp_planted, train_dp_run)
from benchmark.tests.tiny import tiny_cell


def test_bench_dp_ranks_agree_and_match_the_reference():
    c = tiny_cell(*DP_CELL, ranks=2)
    records = train_dp.spawn(c, [(SEED, 1.0)], False, "cpu")[0]
    steps = [rec["steps"] for rec in records]
    assert steps[0] > 0 and steps == [steps[0]] * 2
    assert [len(rec["losses"]) for rec in records] == [3, 3]
    # Each rank drew its own: the ranks' step-1 draws differ.
    assert (records[0]["draws"][0][0] != records[1]["draws"][0][0]).any()
    with one_thread():
        readings = train_dp.check(c, SEED, records, torch.device("cpu"))
    assert readings["replica_gap"] == 0.0
    # Float32 on one thread on both sides: the gradients' sums over the
    # ranks are the only sums whose order may differ.
    assert readings["loss_gap"] < 1e-6, readings
    assert readings["grad_gap"] < 1e-6, readings
    assert readings["change_gap"] < 1e-6, readings
    assert readings["proposal_unmatched"] == 0.0


def test_bench_dp_run_through_the_harness_is_correct():
    ok, compared, readings, res = train_dp_run()
    assert ok, compared
    assert res["cards"] == 2 and res["steps"] > 0
    assert res["train_images_per_s"] == pytest.approx(
        res["steps"] * 2 * 2 / res["window_s"])


@pytest.fixture(scope="module")
def planted():
    plants = ["", "bfloat16", *faults.TRAIN_DP]
    return dict(zip(plants, train_dp_planted(plants)))


def test_bench_dp_sound_job_is_correct(planted):
    ok, compared, _ = planted[""]
    assert ok, compared


def test_bench_dp_bf16_control_fails(planted):
    ok, compared, _ = planted["bfloat16"]
    assert not ok, compared


@pytest.mark.parametrize("fault", faults.TRAIN_DP)
def test_bench_dp_fault_is_caught(planted, fault):
    ok, compared, readings = planted[fault]
    assert not ok, compared
    if fault in ("no_exchange", "no_mean_one_rank"):
        assert readings["replica_gap"] > 0


def test_bench_dp_trainer_that_takes_a_mesh_is_given_it(monkeypatch,
                                                          tmp_path):
    """A `DetectionTrainer` that takes `mesh=` reduces its gradients
    itself: the harness passes the mesh and adds no exchange of its own."""
    import inspect

    from benchmark import common, train
    from benchmark.tests.tiny import tiny_config
    from mot3d_tpu_torch.parallel.mesh import make_mesh
    from mot3d_tpu_torch.train import detection_trainer

    base = detection_trainer.DetectionTrainer
    given = {}

    class MeshTrainer(base):
        def __init__(self, cfg, output_dir, device=None, mesh=None):
            given["mesh"] = mesh
            super().__init__(cfg, output_dir, device=device)
    assert "mesh" not in inspect.signature(base).parameters
    monkeypatch.setattr(detection_trainer, "DetectionTrainer", MeshTrainer)
    conf = tiny_config()
    mesh = make_mesh(device="cpu")
    w_det, _ = common.model_weights(conf, SEED, "cpu")
    trainer = train.make_trainer(common.program_config(conf["config"]),
                                 str(tmp_path), "cpu", w_det, mesh)
    assert given["mesh"] is mesh
    assert not trainer.state.optimizer._optimizer_step_pre_hooks
