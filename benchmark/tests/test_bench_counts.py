"""The frozen FLOP counts recomputed from the reference's shapes, the K1
and K3 work functions, and the configuration files as they are run."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from benchmark import counts

BENCH = Path(__file__).resolve().parents[1]
GATES = {"detection.score_thresh_test": -1.0,
         "combined.objectness_thres": -1.0, "combined.iou2d_thres": -1.0,
         "pose.min_inlier_ratio": 0.0, "tracking.box_iou_thres": 0.0}


def _conf(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["r50fpn-gn", "r50fpn-d2"])
def test_bench_frozen_flops_recomputed_from_shapes(name):
    conf = _conf(name)
    assert counts.serve_flops(conf) == conf["flops"]["serve_sequence"]
    assert counts.train_flops(conf, 2) == conf["flops"]["train_step_b2"]


@pytest.mark.parametrize("name", ["r50fpn-gn", "r50fpn-d2"])
def test_bench_config_file_is_the_port_config_with_its_overrides(name):
    """The file holds Config() (import layout for d2), its overrides and
    the gates opened, and nothing else changed."""
    from mot3d_tpu_torch.config import Config
    from mot3d_tpu_torch.importers.torch_ckpt import import_config
    conf = _conf(name)
    cfg = Config()
    if conf["overrides"].pop("importers.torch_ckpt.import_config"):
        cfg = cfg.replace(detection=import_config(cfg.detection))
    for key, value in {**conf["overrides"], **GATES}.items():
        sec, field = key.split(".")
        cfg = cfg.replace(**{sec: dataclasses.replace(
            getattr(cfg, sec), **{field: value})})
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == conf["config"]
    assert conf["reduced"] == []


def test_bench_k1_work_counts_valid_pairs_and_bytes():
    valid = torch.tensor([[True, True, False, True],
                          [False, False, False, False]])
    cols = torch.tensor([0, 2, 3], dtype=torch.int32)
    ops, nbytes = counts.k1_work(valid, cols)
    # Row 0: 3 valid points x 2 valid candidates; row 1: none.
    assert ops == counts.K1_OPS_PER_PAIR * 6
    assert nbytes == 8 * 12 + 8 + 3 * 4 + 8 * 4


def test_bench_k3_work_counts_each_pair_once():
    valid = torch.zeros((2, 3, 5), dtype=torch.bool)
    valid[0, 0, :4] = True       # 6 pairs
    valid[1, 2, :2] = True       # 1 pair
    ops, nbytes = counts.k3_work(valid)
    assert ops == counts.K3_OPS_PER_PAIR * 7
    assert nbytes == counts.K3_BYTES_PER_BOX * 30


def test_bench_bound_is_the_slower_of_operations_and_bytes():
    assert counts.bound_s(67e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
