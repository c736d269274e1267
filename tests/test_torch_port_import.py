"""The port stands alone: importing it pulls in neither JAX nor flax (nor
the host packages of its file readers, summaries, metrics and smoothing:
h5py, cv2, matplotlib, pandas, scipy), no file of it (nor chip_smoke.py)
imports jax, flax or mot3d_tpu, its config is a faithful copy, and its
entry points default to the GPU and refuse to run without one."""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from mot3d_tpu import config as cfg_j
from mot3d_tpu_torch import config as cfg_t

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mot3d_tpu"}


HOST_PACKAGES = ("h5py", "cv2", "matplotlib", "pandas", "tensorboard", "PIL",
                 "scipy")


# One interpreter for the checks that need a fresh one: pandas blocked,
# every module of the port imported (then: which of jax, flax, mot3d_tpu
# and the host packages got loaded), the host tracker assembling and
# scoring without pandas, and the CLI run as __main__ without a GPU.
FRESH_INTERPRETER = f"""
import importlib, json, pkgutil, runpy, sys
sys.modules["pandas"] = None
import numpy as np, torch, mot3d_tpu_torch
for m in pkgutil.walk_packages(mot3d_tpu_torch.__path__, "mot3d_tpu_torch."):
    importlib.import_module(m.name)
out = {{"loaded": sorted(
    m for m, v in sys.modules.items() if v is not None and m.split(".")[0]
    in ("jax", "jaxlib", "flax", "mot3d_tpu") + {HOST_PACKAGES!r})}}
from mot3d_tpu_torch.config import TrackingConfig
from mot3d_tpu_torch.tracking.tracker import Tracker
t = Tracker(TrackingConfig())
gt = t.gt_trajectories(np.zeros((2, 1), int), np.ones((2, 1), bool),
                       np.zeros((2, 1, 3)), np.zeros((2, 1), int))
out["mota"] = t.evaluate(gt, gt)["mota"]
out["pandas_loaded"] = "pandas" in [m for m, v in sys.modules.items() if v]
torch.cuda.is_available = lambda: False
sys.argv = ["cli", "infer-tracking", "--data", "x", "--ckpt", "y"]
try:
    runpy.run_module("mot3d_tpu_torch.cli", run_name="__main__")
    out["cli_error"] = None
except Exception as e:
    out["cli_error"] = f"{{type(e).__name__}}: {{e}}"
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fresh():
    res = subprocess.run([sys.executable, "-c", FRESH_INTERPRETER],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_import_pulls_in_no_jax(fresh):
    """Every module of the port imported: no JAX, no flax, no mot3d_tpu,
    and none of the host packages its readers, writers, metrics and
    smoothing import inside their functions."""
    assert fresh["loaded"] == []


def test_tracker_imports_without_pandas(fresh):
    """pandas serves `traj_table` only: with it blocked, the host tracker
    and the package still import, assemble and score."""
    assert fresh["mota"] == 1.0 and not fresh["pandas_loaded"]


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
    names = {str(f.relative_to(ROOT / "mot3d_tpu_torch")) for f in files[:-1]}
    assert {"importers/torch_ckpt.py", "importers/torch_export.py",
            "models/siamese.py", "train/siamese_trainer.py",
            "tracking/visualise.py", "tracking/replay.py",
            "tracking/isosurface.py", "utils/pointcloud.py",
            "data/office.py", "tracking/f2f.py", "tracking/heuristic.py",
            "tracking/smoothing.py", "utils/timing.py", "data/synthetic.py",
            "data/synthetic_detection.py", "parallel/mesh.py",
            "parallel/multihost.py", "parallel/dryrun.py",
            "data/voxelize.py", "utils/native.py", "utils/tree.py"} <= names
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


def test_workflow_entry_points_default_to_the_gpu(monkeypatch, tmp_path,
                                                 fresh):
    """The trainers, the exporter, the prefetcher and the CLI raise without
    a GPU unless asked for the CPU; with device='cpu' they are built."""
    from mot3d_tpu_torch import cli
    from mot3d_tpu_torch.data.prefetch import device_prefetch
    from mot3d_tpu_torch.export import DetectorExporter
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.train.detection_trainer import DetectionTrainer
    from mot3d_tpu_torch.train.tracking_trainer import TrackingTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg_t.Config()
    for build in (lambda d: DetectionTrainer(cfg, str(tmp_path / "d"), d),
                  lambda d: TrackingTrainer(cfg, str(tmp_path / "t"), d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(None)
    TrackingTrainer(cfg, str(tmp_path / "t"), "cpu")
    det = MaskRCNN(cfg.detection, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectorExporter(cfg, det)
    assert DetectorExporter(cfg, det, "cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_prefetch(iter([np.zeros(2)])))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["export-detections", "--data", str(tmp_path), "--out",
                  str(tmp_path / "h5")])
    assert fresh["cli_error"].startswith("RuntimeError") and \
        "device='cpu'" in fresh["cli_error"]


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


def test_former_refusals_now_build():
    """infer-office, pose.extraction="full" and detection.compute_dtype=
    "bfloat16" are ported: the CLI reaches its own data check, the office
    path refuses to leave the GPU on its own, both switches build, and
    unknown values raise ValueError.  The only NotImplementedError left in
    the package is K2's missing gradient (ROADMAP.md Queue 1)."""
    from mot3d_tpu_torch import cli
    from mot3d_tpu_torch.data.office import OfficeDataset, office_inference
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.pose.pipeline import _check_extraction

    with pytest.raises(FileNotFoundError):
        cli.main(["infer-office", "--data", str(ROOT / "no_such_dir"),
                  "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["infer-office", "--data", "x", "--tracker", "oracle"])
    cfg = cfg_t.Config()
    _check_extraction(cfg.replace(pose=dataclasses.replace(
        cfg.pose, extraction="full")))
    with pytest.raises(ValueError, match="extraction"):
        _check_extraction(cfg.replace(pose=dataclasses.replace(
            cfg.pose, extraction="dense")))
    tiny = dataclasses.replace(cfg.detection, backbone_width=0.25,
                               fpn_channels=64, head_width_mult=0.125)
    MaskRCNN(dataclasses.replace(tiny, compute_dtype="bfloat16"),
             device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        MaskRCNN(dataclasses.replace(tiny, compute_dtype="fp8"),
                 device="cpu")
    with mock.patch.object(torch.cuda, "is_available", lambda: False), \
            pytest.raises(RuntimeError, match="device='cpu'"):
        office_inference(cfg, torch.nn.Linear(1, 1),
                         mock.Mock(spec=OfficeDataset), "scene")
    raising = []
    for path in sorted((ROOT / "mot3d_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Raise) and "NotImplementedError" in \
                    ast.dump(node):
                raising.append(str(path.relative_to(ROOT)))
    assert raising == ["mot3d_tpu_torch/parallel/train_step.py"]


def test_ported_entry_points_no_longer_raise(tmp_path):
    """import-torch-ckpt, train-siamese, infer-siamese, --export-vis and
    graph.time_aware_mp=True are ported: they reach their own argument
    and data checks instead of a NotImplementedError."""
    from mot3d_tpu_torch import cli
    from mot3d_tpu_torch.models.mpn import TrackerModel

    with pytest.raises(SystemExit, match="nothing to import"):
        cli.main(["import-torch-ckpt", "--out", str(tmp_path / "o"),
                  "--device", "cpu"])
    empty = str(tmp_path)
    for argv in (["train-siamese", "--data", empty, "--val-data", empty],
                 ["infer-siamese", "--data", empty, "--ckpt", empty,
                  "--export-vis"],
                 ["infer-tracking", "--data", empty, "--ckpt", empty,
                  "--export-vis"]):
        with pytest.raises(FileNotFoundError, match="no scene directories"):
            cli.main(argv + ["--device", "cpu"])
    cfg = cfg_t.Config()
    TrackerModel(dataclasses.replace(cfg.graph, time_aware_mp=True),
                 device="cpu")
