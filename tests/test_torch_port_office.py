"""Parity of the port's office path against the JAX package, on the CPU: the
office reader, F2F segment centres, the heuristic and F2F trackers,
`eval_f2f`, trajectory smoothing, `office_inference` in both tracker modes
and the `infer-office` CLI.

Inputs are made from seeds with numpy.  The detector is the tiny one of
tests/test_office_inference.py (64 x 64 frames, backbone_width 0.25),
random weights from `random_params`, carried across by
`importers/flax_params.py`, with two edits that keep the comparison about
the pipeline rather than rounding (see test_torch_port_infer.py): a
sharpened mask predictor (probabilities away from the 0.5 threshold) and a
NOCS head that answers 0.5 everywhere (each fit's source is the origin, so
its translation is the centroid of its kept depth points), and a voxel
head that leaves every cell empty.
Both frameworks run in float64 (JAX under `jax.enable_x64`, the port's
model after `.double()`), as in test_torch_port_infer.py: in float32 the
constant NOCS source varies by rounding only, which makes every fit's
scale and translation arbitrary.  The JAX CLI runs once per tracker mode
(its `_init_detector` returns these weights; `office_inference` is wrapped
to keep its per-frame output); the port's CLI reads the same weights from
one of its checkpoints (the model then goes to float64) and gets JAX's
RANSAC draws (`slot_draws` along JAX's chained `rng, sub = split(rng)`,
rebuilt under x64).

Tolerances: reader outputs, tracker output, `eval_f2f`, trajectory
structure (frames, identities, classes) and voxels exact (no cell sits
at the threshold, and no isosurface is exported: posed-shape OBJs are
pinned by test_torch_port_visualise.py); segment centres
1e-5; smoothing 1e-12 (the same float64 numpy and scipy); per-frame and
trajectory locations and world boxes 1e-4, detector boxes 5e-4 px (the
flax heads cast their outputs to float32 even under x64, the port's stay
float64; F2F centres are float32 in both).  The degenerate fits' rotations and scales are checked for
consistency with cad2world on each side, not across sides (well-posed
rotations are pinned by test_torch_port_pose.py).  The CLIs run on one
scene: each JAX `office_inference` call compiles its programs anew.
"""

import contextlib
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from mot3d_tpu import cli as cli_j
from mot3d_tpu.config import Config as ConfigJ
from mot3d_tpu.config import apply_overrides as apply_overrides_j
from mot3d_tpu.data import office as office_j
from mot3d_tpu.models.mask_rcnn import MaskRCNN as MaskRCNNJ
from mot3d_tpu.tracking import smoothing as smooth_j
from mot3d_tpu.tracking.f2f import F2FTracker as F2FJ
from mot3d_tpu.tracking.f2f import eval_f2f as eval_j
from mot3d_tpu.tracking.f2f import segment_centers as centres_j
from mot3d_tpu.tracking.heuristic import HeuristicTracker as HeurJ
from mot3d_tpu_torch import cli as cli_t
from mot3d_tpu_torch.data import office as office_t
from mot3d_tpu_torch.data.fixtures import write_office_fixture
from mot3d_tpu_torch.importers.flax_params import mask_rcnn_state_dict
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN as MaskRCNNT
from mot3d_tpu_torch.tracking import smoothing as smooth_t
from mot3d_tpu_torch.tracking.f2f import F2FTracker as F2FT
from mot3d_tpu_torch.tracking.f2f import eval_f2f as eval_t
from mot3d_tpu_torch.tracking.f2f import segment_centers as centres_t
from mot3d_tpu_torch.tracking.heuristic import HeuristicTracker as HeurT
from mot3d_tpu_torch.train.checkpoints import CheckpointManager
from mot3d_tpu_torch.train.combined_trainer import detection_optimizer
from mot3d_tpu_torch.train.detection_trainer import DetectionTrainState
from torch_port_helpers import (OFFICE_TINY, port_config, random_params,
                                slot_draws)

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def office_root(tmp_path_factory):
    """One scene of two 128 x 128 frames with person masks (read at
    64 x 64) and a second scene without them."""
    root = str(tmp_path_factory.mktemp("office"))
    write_office_fixture(root, num_scenes=2, num_frames=2, seed=3,
                         hw=(128, 128), intrinsics=(128.0, 128.0, 63.5, 63.5))
    return root


@pytest.fixture(scope="module")
def weights():
    cfg = apply_overrides_j(ConfigJ(), OFFICE_TINY)
    model = MaskRCNNJ(cfg.detection)
    params = random_params(model, jnp.zeros((1, 64, 64, 3)), seed=4,
                           method=MaskRCNNJ.predict)
    params["params"]["mask_head"]["Conv_4"]["kernel"] *= 5.0
    nocs = params["params"]["nocs_head"]["ConvTranspose_3"]
    nocs["kernel"] *= 0.0      # NOCS 0.5 everywhere: a source at the
    nocs["bias"] *= 0.0        # origin, whatever the fit's rotation
    vox = params["params"]["voxel_head"]["ConvTranspose_4"]
    vox["kernel"] *= 0.0       # every voxel empty: no cell at the
    vox["bias"] -= 3.0         # threshold, no isosurface to export
    return cfg, model, params


@pytest.fixture(scope="module")
def port_ckpt(weights, tmp_path_factory):
    """The same weights in one of the port's detection checkpoints."""
    cfg, _, params = weights
    cfg_t = port_config(cfg)
    model = MaskRCNNT(cfg_t.detection, device="cpu")
    model.load_state_dict(mask_rcnn_state_dict(params, cfg_t))
    out = str(tmp_path_factory.mktemp("ckpt"))
    CheckpointManager(os.path.join(out, "ckpt")).save(
        0, DetectionTrainState(model, *detection_optimizer(cfg_t, model)))
    return out


def _jax_draws(cfg, n_frames):
    """JAX office_inference's draws: rng = PRNGKey(0), then per frame
    rng, sub = split(rng) and `slot_draws(sub, ...)`."""
    rng, out = jax.random.PRNGKey(0), []
    for _ in range(n_frames):
        rng, sub = jax.random.split(rng)
        out.append(slot_draws(sub, cfg.detection.detections_per_image,
                              cfg.pose.ransac_iters,
                              cfg.pose.ransac_sample_size))
    return np.stack(out)


def _run_cli(cli, module, argv, extra=None, **init):
    """One `infer-office` run of a CLI whose `office_inference` is wrapped
    to record its output per scene (with `extra` keyword arguments)."""
    seen = {}
    real = module.office_inference

    def wrapped(cfg, *a, **kw):
        out = real(cfg, *a, **{**kw, **(extra or {})})
        seen[a[-1]] = out          # the scene, the last positional argument
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(module, "office_inference",
                                              wrapped))
        for name, value in init.items():
            stack.enter_context(mock.patch.object(cli, name, value))
        cli.main(argv)
    return seen


@pytest.fixture(scope="module", params=["heuristic", "f2f"])
def runs(request, weights, port_ckpt, office_root, tmp_path_factory):
    """Both CLIs on the office tree in one tracker mode: (mode, JAX's
    per-scene (trajectories, per_frame), the port's, output dirs)."""
    mode = request.param
    cfg, model, params = weights
    flags = ["--scene", "scene00", "--tracker", mode, "--fuse"]
    if mode == "heuristic":
        flags += ["--fuse-shapes", "--mask-person"]
    out_j = str(tmp_path_factory.mktemp(f"jax_{mode}"))
    out_t = str(tmp_path_factory.mktemp(f"port_{mode}"))
    params64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      params)
    with jax.enable_x64(True):
        seen_j = _run_cli(cli_j, office_j,
                          ["infer-office", "--data", office_root, "--out",
                           out_j] + flags + OFFICE_TINY,
                          _init_detector=lambda *a: (model, params64))
        draws = _jax_draws(cfg, 2)
    init_t = cli_t._init_detector
    seen_t = _run_cli(cli_t, office_t,
                      ["infer-office", "--data", office_root, "--out", out_t,
                       "--ckpt", port_ckpt, "--device", "cpu"] + flags + OFFICE_TINY,
                      extra={"draws": torch.from_numpy(draws)},
                      _init_detector=lambda *a: init_t(*a).double())
    return mode, seen_j, seen_t, out_j, out_t


def _close(a, b, what, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0,
                               err_msg=what)


# ---------------------------------------------------------------- reader


@pytest.mark.parametrize("mask_person", [False, True])
def test_office_dataset_matches_jax(office_root, mask_person):
    ds_j = office_j.OfficeDataset(office_root, (64, 64), mask_person)
    ds_t = office_t.OfficeDataset(office_root, (64, 64), mask_person)
    assert ds_t.scenes == ds_j.scenes == ["scene00", "scene01"]
    people = 0
    for scene in ds_t.scenes:
        assert ds_t.frames(scene) == ds_j.frames(scene)
        for name in ds_t.frames(scene):
            a, b = ds_t.load_frame(scene, name), ds_j.load_frame(scene, name)
            for field in ("rgb", "depth", "person_mask", "intrinsics"):
                x, y = getattr(a, field), getattr(b, field)
                assert x.dtype == y.dtype and np.array_equal(x, y), field
            assert (a.scene, a.name) == (b.scene, b.name)
            people += int(a.person_mask.sum())
    assert people > 0


# ------------------------------------------------------------ F2F centres


def test_segment_centers_match_jax():
    """A random frame of 6 detections: spilling masks, one invalid slot,
    one box off the image, one empty mask; camera and world space."""
    rng = np.random.default_rng(5)
    h, w = 40, 48
    depth = rng.uniform(1.0, 3.0, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = 0.0
    intr = np.float32([[50.0, 0, 23.5], [0, 52.0, 19.5], [0, 0, 1]])
    masks = rng.uniform(0, 1, (6, h, w)).astype(np.float32)
    masks[4] = 0.2
    xy = rng.uniform(0, 30, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (6, 2))],
                           -1).astype(np.float32)
    boxes[3] = [60.0, 50.0, 70.0, 60.0]
    valid = np.array([True, True, False, True, True, True])
    campose = np.eye(4, dtype=np.float32)
    campose[:3, :3] = np.float32([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    campose[:3, 3] = [1.0, 2.0, 3.0]
    for pose in (None, campose):
        args = (masks, boxes, valid, depth, intr)
        cj, hj = jax.jit(centres_j)(*(jnp.asarray(a) for a in args),
                                    None if pose is None
                                    else jnp.asarray(pose))
        ct, ht = centres_t(*(torch.from_numpy(a) for a in args),
                           None if pose is None else torch.from_numpy(pose))
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
        assert ht.numpy().tolist() == [True, True, False, False, False, True]
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5,
                                   rtol=0)


# -------------------------------------------------- trackers and metrics


def _detections(seed=6, frames=8):
    """Per-frame detection dicts of three drifting objects with noise,
    drops, a same-frame duplicate and a far spurious detection."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(-1, 1, (3, 3))
    per_frame, gt = [], [[], [], []]
    for t in range(frames):
        dets = []
        for k in range(3):
            loc = start[k] + 0.05 * t * np.array([1.0, 0.3, -0.2])
            gt[k].append({"loc": loc, "scan_idx": t, "obj_idx": 10 + k})
            if rng.uniform() < 0.15:
                continue
            dets.append({"loc": loc + rng.normal(0, 0.03, 3), "cls": k})
        if t == 3:
            dets.append({"loc": dets[0]["loc"] + 0.05, "cls": 0})
        if t == 5:
            dets.append({"loc": np.array([5.0, 5.0, 5.0]), "cls": 2})
        per_frame.append(dets)
    return per_frame, gt


def _same_trajectories(a, b, tol=0.0):
    assert len(a) == len(b) and len(a) > 0
    for ta, tb in zip(a, b):
        assert [(d["scan_idx"], d["obj_idx"], d.get("cls")) for d in ta] == \
            [(d["scan_idx"], d["obj_idx"], d.get("cls")) for d in tb]
        for da, db in zip(ta, tb):
            if tol:
                _close(da["loc"], db["loc"], "loc", tol)
            else:
                np.testing.assert_array_equal(da["loc"], db["loc"])


@pytest.mark.parametrize("dist_thres", [0.1, 0.25])
def test_trackers_and_eval_f2f_match_jax(dist_thres):
    per_frame, gt = _detections()
    heur_j = HeurJ(dist_thres, seq_len=8).track(per_frame)
    heur_t = HeurT(dist_thres, seq_len=8).track(per_frame)
    _same_trajectories(heur_t, heur_j)
    f2f_j = F2FJ(dist_thres, seq_len=8).track(per_frame)
    f2f_t = F2FT(dist_thres, seq_len=8).track(per_frame)
    _same_trajectories(f2f_t, f2f_j)
    for gate in (0.05, 0.4):
        mj = eval_j(f2f_j, gt, seq_len=8, dist_gate=gate)
        mt = eval_t(f2f_t, gt, seq_len=8, dist_gate=gate)
        assert mt == mj and 0 < mt["f1"] <= 1


# -------------------------------------------------------------- smoothing


def _scaled_yaw(yaw, scale=1.0):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) * scale


def _smoothing_cases():
    """name -> trajectory: the cases of tests/test_f2f.py (a gap, a
    negative initial yaw, a duplicated frame) plus a tilted, noisy track
    with Euler angles, and a one-entry track."""
    rng = np.random.default_rng(7)
    gap = []
    for t in (0, 1, 3, 4):
        c2w = np.identity(4)
        c2w[:3, :3] = _scaled_yaw(0.3 + 0.01 * t, 2.0)
        c2w[:3, 3] = [0.1 * t, 0.0, 1.0]
        gap.append({"scan_idx": t, "cad2world": c2w, "obj_idx": 7,
                    "loc": c2w[:3, 3].copy(), "cls": 2})
    negative = []
    for t in range(4):
        c2w = np.identity(4)
        c2w[:3, :3] = _scaled_yaw(-1.0 + 0.02 * t)
        c2w[:3, 3] = [0.1 * t, 0, 0]
        negative.append({"scan_idx": t, "cad2world": c2w})
    noisy = []
    for t in (0, 1, 2, 5, 6, 9):
        euler = np.array([0.1, -0.4 + 0.05 * t, 0.2]) + rng.normal(0, 0.02, 3)
        c2w = np.identity(4)
        c2w[:3, :3] = Rotation.from_euler("xyz", euler).as_matrix() * 1.3
        c2w[:3, 3] = rng.normal(0, 0.05, 3) + [0.02 * t, 0.5, 2.0]
        noisy.append({"scan_idx": t, "euler": euler, "loc": c2w[:3, 3],
                      "cad2world": c2w, "scale": 1.3,
                      "voxel": np.full((2, 2, 2), t, np.float32)})
    return {"gap": gap, "negative_yaw": negative,
            "duplicate_frame": gap + [dict(gap[1])], "noisy": noisy,
            "single": gap[:1]}


def _same_records(a, b):
    assert len(a) == len(b)
    for da, db in zip(a, b):
        assert set(da) == set(db)
        for key in da:
            if isinstance(da[key], (np.ndarray, float)):
                np.testing.assert_allclose(da[key], db[key], atol=1e-12,
                                           rtol=0, err_msg=key)
            else:
                assert da[key] == db[key], key


@pytest.mark.parametrize("case", ["gap", "negative_yaw", "duplicate_frame",
                                  "noisy", "single"])
def test_smoothing_matches_jax(case):
    traj = _smoothing_cases()[case]
    for kw in ({}, {"sigma": 1.0, "constraint": False}):
        _same_records(smooth_t.fuse_pose_f2f(traj, **kw),
                      smooth_j.fuse_pose_f2f(traj, **kw))
    if "loc" in traj[0]:
        for kw in ({}, {"sigma_translation": 2.0, "sigma_rotation": 0.5}):
            out = smooth_t.fuse_pose(traj, **kw)
            _same_records(out, smooth_j.fuse_pose(traj, **kw))
        for a, b in zip(smooth_t.fuse_trajectories([traj, traj[:2]]),
                        smooth_j.fuse_trajectories([traj, traj[:2]])):
            _same_records(a, b)
    scaled = traj[0]["cad2world"][:3, :3]
    for x, y in zip(smooth_t._unscale(scaled), smooth_j._unscale(scaled)):
        np.testing.assert_array_equal(x, y)
    if case == "negative_yaw":
        yaws = np.array([d["euler"][2] for d in
                         smooth_t.fuse_pose_f2f(traj, sigma=1.0)])
        assert (np.abs(yaws + 1.0) < 0.25).all()
        assert len(np.unique(np.round(yaws, 6))) > 1


# ------------------------------------------------- office_inference, CLI


def test_office_inference_and_cli_match_jax(runs):
    """Per scene: every frame's detections (locations, Euler angles,
    scales, cad2world, classes, voxels and boxes in heuristic mode; centres,
    classes and 2D boxes in F2F mode), the trajectories, and the CLI's
    trajectories.json and replay page."""
    mode, seen_j, seen_t, out_j, out_t = runs
    assert sorted(seen_t) == sorted(seen_j) == ["scene00"]
    n_dets = 0
    for scene in seen_t:
        (traj_t, frames_t), (traj_j, frames_j) = seen_t[scene], seen_j[scene]
        assert len(frames_t) == len(frames_j) == 2
        for ft, fj in zip(frames_t, frames_j):
            assert len(ft) == len(fj)
            n_dets += len(ft)
            for dt, dj in zip(ft, fj):
                assert set(dt) == set(dj) and dt["cls"] == dj["cls"]
                for key in set(dt) & {"loc", "box"}:
                    _close(dt[key], dj[key], f"{scene} {key}")
                if mode == "f2f":
                    _close(dt["box2d"], dj["box2d"], "box2d", atol=5e-4)
                if mode == "heuristic":
                    np.testing.assert_array_equal(dt["voxel"], dj["voxel"])
                    for d in (dt, dj):
                        c2w = np.identity(4)
                        c2w[:3, :3] = Rotation.from_euler(
                            "xyz", d["euler"]).as_matrix() * d["scale"]
                        c2w[:3, 3] = d["loc"]
                        np.testing.assert_allclose(d["cad2world"], c2w,
                                                   atol=1e-12, rtol=0)
        _same_trajectories(traj_t, traj_j, tol=1e-4)
        with open(os.path.join(out_t, scene, "trajectories.json")) as f:
            js_t = json.load(f)
        with open(os.path.join(out_j, scene, "trajectories.json")) as f:
            js_j = json.load(f)
        assert [[(d["scan_idx"], d["cls"]) for d in t] for t in js_t] == \
            [[(d["scan_idx"], d["cls"]) for d in t] for t in js_j]
        _close([d["loc"] for t in js_t for d in t],
               [d["loc"] for t in js_j for d in t], "json loc")
        assert os.path.exists(os.path.join(out_t, scene, "replay.html"))
        assert sorted(os.listdir(os.path.join(out_t, scene))) == \
            sorted(os.listdir(os.path.join(out_j, scene)))
    assert n_dets >= 4     # the pipeline really produced detections
    if mode == "f2f":
        assert all("euler" not in d for f in frames_t for d in f)
