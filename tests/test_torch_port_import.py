"""The port stands alone: importing it pulls in neither JAX nor flax, no file
of it (nor chip_smoke.py) imports jax, flax or mot3d_tpu, its config is a
faithful copy, and its entry points default to the GPU and refuse to run
without one."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mot3d_tpu import config as cfg_j
from mot3d_tpu_torch import config as cfg_t

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mot3d_tpu"}


def test_import_pulls_in_no_jax():
    code = ("import sys, mot3d_tpu_torch, mot3d_tpu_torch.parallel.infer_step, "
            "mot3d_tpu_torch.importers.flax_params, "
            "mot3d_tpu_torch.tracking.tracker, "
            "mot3d_tpu_torch.evaluator.edge_metrics, "
            "mot3d_tpu_torch.train.combined_trainer; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mot3d_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_tracker_imports_without_pandas():
    """pandas serves `traj_table` only: with it blocked, the host tracker
    and the package still import, assemble and score."""
    code = ("import sys; sys.modules['pandas'] = None; "
            "import numpy as np, mot3d_tpu_torch; "
            "from mot3d_tpu_torch.tracking.tracker import Tracker; "
            "from mot3d_tpu_torch.config import TrackingConfig; "
            "t = Tracker(TrackingConfig()); "
            "gt = t.gt_trajectories(np.zeros((2, 1), int), "
            "np.ones((2, 1), bool), np.zeros((2, 1, 3)), "
            "np.zeros((2, 1), int)); "
            "assert t.evaluate(gt, gt)['mota'] == 1.0; "
            "assert 'pandas' not in [m for m, v in sys.modules.items() if v]")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_no_file_imports_jax_flax_or_the_jax_package():
    files = sorted((ROOT / "mot3d_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_config_is_a_faithful_copy():
    assert dataclasses.asdict(cfg_t.Config()) == \
        dataclasses.asdict(cfg_j.Config())
    for name in ("CameraConfig", "TrackingConfig"):
        a, b = getattr(cfg_j, name)(), getattr(cfg_t, name)()
        for prop in ("cx", "cy", "max_nodes", "max_directed_edges"):
            if hasattr(a, prop):
                assert getattr(a, prop) == getattr(b, prop)
    ov = ["pose.extraction=pallas", "detection.anchor_sizes=8,16",
          "tracking.undirected=false", "pose.ratio_adapt=2"]
    assert dataclasses.asdict(cfg_t.apply_overrides(cfg_t.Config(), ov)) == \
        dataclasses.asdict(cfg_j.apply_overrides(cfg_j.Config(), ov))


def test_entry_points_default_to_the_gpu(monkeypatch):
    from mot3d_tpu_torch.models.mpn import TrackerModel
    from mot3d_tpu_torch.parallel.infer_step import make_sequence_infer_step
    from mot3d_tpu_torch.tracking.graph_builder import make_template

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg_t.Config()
    trk = TrackerModel(cfg.graph, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sequence_infer_step(None, trk, make_template(2, 2, 1), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrackerModel(cfg.graph)
    from mot3d_tpu_torch.parallel.train_step import (
        make_combined_train_step, make_tracking_train_step)
    from mot3d_tpu_torch.train.combined_trainer import CombinedTrainer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_combined_train_step(None, trk, make_template(2, 2, 1), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tracking_train_step(trk, make_template(2, 2, 1), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CombinedTrainer(cfg, "unused")


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    """A CPU tensor runs the plain version without building anything; a
    tensor on any other non-CUDA device is refused, never computed."""
    from mot3d_tpu_torch.ops.cuda import knn_outlier, pose_extract

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
    valid = torch.ones(2, 64, dtype=torch.bool)
    cols = torch.arange(0, 64, 4, dtype=torch.int32)
    before = knn_outlier.launches.count
    out = knn_outlier.knn_mean_dists(pts, valid, cols, 3)
    assert out.shape == (2, 64) and torch.isfinite(out).all()
    assert knn_outlier.launches.count == before   # no kernel launched
    with pytest.raises(ValueError, match="device"):
        knn_outlier.knn_mean_dists(pts.to("meta"), valid.to("meta"),
                                   cols.to("meta"), 3)
    nocs = torch.rand(2, 28, 28, 3)
    with pytest.raises(ValueError, match="device"):
        pose_extract.pose_extract(nocs.to("meta"), torch.rand(2, 28, 28),
                                  torch.zeros(2, 4), torch.ones(8, 8),
                                  torch.eye(3))
