"""Parity of the port's data feeds, evaluators and pose helpers against the
JAX package, on the CPU.

Host-side numpy code (binvox, the MOTFront reader, the fixture writer,
`load_frame`, the .h5 interchange, `pad_sequence`, the batch iterator,
RLE, COCO AP) must agree exactly: equal arrays, equal dicts.  The torch
functions (`rotation_error_deg`, `location_error`, `paste_patch`,
`crop_gt_box3d`) run in float32 on both sides and agree to rtol 1e-5,
atol 1e-5 (units: degrees, metres, NOCS values, metres) unless a test
states another tolerance.
"""

import json
import os

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mot3d_tpu.data import binvox as binvox_j
from mot3d_tpu.data import detection_loader as loader_j
from mot3d_tpu.data import fixtures as fixtures_j
from mot3d_tpu.data import h5_io as h5_j
from mot3d_tpu.data import motfront as motfront_j
from mot3d_tpu.evaluator import coco_eval as coco_j
from mot3d_tpu.evaluator import rle as rle_j
from mot3d_tpu.geometry import metrics as metrics_j
from mot3d_tpu.geometry.backproject import make_intrinsics as intr_j
from mot3d_tpu.geometry.transforms import euler_to_rotmat as e2r_j
from mot3d_tpu.pose import pipeline as pipeline_j
from mot3d_tpu_torch.data import binvox as binvox_t
from mot3d_tpu_torch.data import detection_loader as loader_t
from mot3d_tpu_torch.data import fixtures as fixtures_t
from mot3d_tpu_torch.data import h5_io as h5_t
from mot3d_tpu_torch.data import motfront as motfront_t
from mot3d_tpu_torch.data.prefetch import device_prefetch
from mot3d_tpu_torch.evaluator import coco_eval as coco_t
from mot3d_tpu_torch.evaluator import rle as rle_t
from mot3d_tpu_torch.geometry import metrics as metrics_t
from mot3d_tpu_torch.geometry.backproject import make_intrinsics
from mot3d_tpu_torch.geometry.transforms import euler_to_rotmat
from mot3d_tpu_torch.pose import pipeline as pipeline_t
from torch_port_helpers import port_config, to_torch

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
CFG = _tiny_config()
CFG_T = port_config(CFG)
SPLITS = {"train": (2, 3), "val": (1, 3)}      # scenes, frames


def _equal(a, b, what=""):
    """Two trees of arrays / NamedTuples / lists / dicts / scalars equal."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same fixture written by both packages' writers (64 x 64 camera,
    two splits, each split from its own seed)."""
    root = tmp_path_factory.mktemp("fixtures")
    for name, write in (("jax", fixtures_j.write_motfront_fixture),
                        ("port", fixtures_t.write_motfront_fixture)):
        for seed, (split, (n, t)) in enumerate(SPLITS.items()):
            write(str(root / name), split, num_scenes=n, num_frames=t,
                  num_objects=3, seed=seed + 1, cam=CFG.camera,
                  camera_dist=2.6, half_range=(0.35, 0.6))
    return root


# ---------------------------------------------------------------- binvox


@pytest.mark.parametrize("scale", [(1.0, 1.0, 1.0), (0.6, 1.0, 0.8)])
def test_binvox_round_trip_and_rescale_match_jax(tmp_path, scale):
    """Each package reads the other's file; rescale_voxel equal."""
    rng = np.random.default_rng(0)
    grid = rng.uniform(size=(32, 32, 32)) < 0.3
    grid[4:20, 2:30, 8:24] = True
    binvox_t.write_binvox(str(tmp_path / "t.binvox"), grid, (1, 2, 3), 0.5)
    binvox_j.write_binvox(str(tmp_path / "j.binvox"), grid, (1, 2, 3), 0.5)
    assert (tmp_path / "t.binvox").read_bytes() == \
        (tmp_path / "j.binvox").read_bytes()
    _equal(binvox_t.read_binvox(str(tmp_path / "j.binvox")),
           binvox_j.read_binvox(str(tmp_path / "t.binvox")))
    _equal(binvox_t.rescale_voxel(grid.astype(np.int64), np.array(scale)),
           binvox_j.rescale_voxel(grid.astype(np.int64), np.array(scale)))


# ---------------------------------------------------- fixture and reader


def test_fixture_writer_writes_what_the_jax_writer_writes(trees):
    """Both trees read back equal: every json, png (decoded), hdf5 dataset
    and binvox grid, under the same relative paths."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    jroot, troot = trees / "jax", trees / "port"
    names = files(jroot)
    assert names == files(troot) and len(names) > 30
    for rel in names:
        a, b = str(jroot / rel), str(troot / rel)
        if rel.endswith(".json"):
            _equal(json.load(open(a)), json.load(open(b)), rel)
        elif rel.endswith(".png"):
            _equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                   cv2.imread(b, cv2.IMREAD_UNCHANGED), rel)
        elif rel.endswith(".hdf5"):
            with h5py.File(a) as fa, h5py.File(b) as fb:
                assert sorted(fa) == sorted(fb)
                for k in fa:
                    _equal(np.array(fa[k]), np.array(fb[k]), f"{rel}:{k}")
        elif rel.endswith(".binvox"):
            _equal(binvox_j.read_binvox(a), binvox_t.read_binvox(b), rel)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel


def test_reader_and_load_frame_match_jax(trees):
    """MOTFrontDataset (scenes, records with contiguous first-seen category
    ids, voxels, dataset_info) and every frame's load_frame equal; the
    in-memory `fixture_samples` of the rendered scenes equal load_frame of
    the written files (no file needed)."""
    root = str(trees / "port")
    for split, (n, t) in SPLITS.items():
        dj = motfront_j.MOTFrontDataset(root, split)
        dt = motfront_t.MOTFrontDataset(root, split)
        assert dt.scenes() == dj.scenes() and len(dt.scenes()) == n
        recs_t = [dt.load_scene(s) for s in dt.scenes()]
        recs_j = [dj.load_scene(s) for s in dj.scenes()]
        _equal(recs_t, recs_j, split)
        assert dt.mapping_list == dj.mapping_list
        assert dt.name_list == dj.name_list
        _equal(dt.dataset_info(), dj.dataset_info())
        a = recs_t[0].frames[0].annotations[0]
        _equal(dt.load_voxel(a.jid, a.scale3d),
               dj.load_voxel(a.jid, a.scale3d))
        frames = []
        for rj, rt in zip(recs_j, recs_t):
            for fj, ft in zip(rj.frames, rt.frames):
                st = loader_t.load_frame(dt, ft, CFG_T.detection)
                _equal(st, loader_j.load_frame(dj, fj, CFG.detection))
                frames.append(st)
        assert sum(int(s.valid.sum()) for s in frames) >= 2 * n * t
        seed = list(SPLITS).index(split) + 1
        mem = fixtures_t.fixture_samples(
            fixtures_t.render_motfront_scenes(
                n, t, 3, seed, CFG_T.camera, camera_dist=2.6,
                half_range=(0.35, 0.6)), CFG_T.detection)
        _equal([s for scene in mem for s in scene], frames, "in-memory")


def test_sort_bbox_np_matches_jax():
    from mot3d_tpu.geometry.transforms import sort_bbox_np as sort_j
    from mot3d_tpu_torch.geometry.transforms import sort_bbox_np as sort_t
    rng = np.random.default_rng(3)
    for _ in range(5):
        box = rng.normal(size=(8, 3)).astype(np.float32)
        box[:4, 1] = box[0, 1]                 # ties within the y groups
        _equal(sort_t(box), sort_j(box))


# --------------------------------------------------------- batch feeding


def test_iterate_detection_batches_order_and_cache(trees, monkeypatch):
    """Two shuffled epochs in the JAX iterator's order (the seeded
    permutation stream), then a cached pass decodes each frame once; a
    loader error reaches the consumer."""
    root = str(trees / "port")
    dj = motfront_j.MOTFrontDataset(root, "train")
    dt = motfront_t.MOTFrontDataset(root, "train")
    kw = dict(shuffle=True, seed=5, epochs=2)
    want = list(loader_j.iterate_detection_batches(dj, CFG.detection, 2,
                                                   **kw))
    got = list(loader_t.iterate_detection_batches(dt, CFG_T.detection, 2,
                                                  **kw))
    assert len(got) == len(want) == 6
    _equal(got, want)

    calls = []
    orig = loader_t.load_frame
    monkeypatch.setattr(loader_t, "load_frame",
                        lambda *a: calls.append(1) or orig(*a))
    cached = list(loader_t.iterate_detection_batches(
        dt, CFG_T.detection, 3, shuffle=False, epochs=3, cache_samples=6))
    assert len(cached) == 6 and len(calls) == 6
    _equal(cached[0], loader_t.stack_samples(
        [orig(dt, f, CFG_T.detection)
         for f in dt.load_scene(dt.scenes()[0]).frames]))

    def broken(*a):
        raise OSError("unreadable frame")

    monkeypatch.setattr(loader_t, "load_frame", broken)
    with pytest.raises(OSError, match="unreadable"):
        list(loader_t.iterate_detection_batches(dt, CFG_T.detection, 2))


def test_device_prefetch_on_the_cpu_keeps_order_and_raises():
    """On device='cpu' the batches come through in order as tensors; an
    error of the source is raised in the consumer, after the batches
    before it."""
    batches = [loader_t.DetectionSample(*(np.full((2, 3), i, np.float32)
                                          for _ in range(14)))
               for i in range(4)]
    out = list(device_prefetch(iter(batches), "cpu"))
    assert [int(b.image[0, 0]) for b in out] == [0, 1, 2, 3]
    assert all(isinstance(x, torch.Tensor) for x in out[0])

    def failing():
        yield batches[0]
        raise ValueError("bad batch")

    seen = []
    with pytest.raises(ValueError, match="bad batch"):
        for b in device_prefetch(failing(), "cpu"):
            seen.append(b)
    assert len(seen) == 1


# ------------------------------------------------------------ h5 files


def _frame(rng, n, g):
    return h5_j.FrameDetections(
        classes=rng.integers(0, 7, n).astype(np.int32),
        objectness_scores=rng.uniform(0.4, 1.0, n).astype(np.float32),
        voxels=(rng.uniform(size=(n, 32, 32, 32)) < 0.2).astype(np.float32),
        rotations=rng.normal(size=(n, 3)).astype(np.float32),
        translations=rng.normal(size=(n, 3)).astype(np.float32),
        scales=rng.uniform(0.5, 2, n).astype(np.float32),
        pred_boxes=rng.normal(size=(n, 8, 3)).astype(np.float32),
        gt_ids=np.arange(g, dtype=np.int32),
        gt_boxes=rng.normal(size=(g, 8, 3)).astype(np.float32),
        gt_voxels=(rng.uniform(size=(g, 32, 32, 32)) < 0.2).astype(
            np.float32),
        gt_rotations=rng.normal(size=(g, 3)).astype(np.float32),
        gt_locations=rng.normal(size=(g, 3)).astype(np.float32),
        gt_scales=rng.uniform(0.5, 2, g).astype(np.float32),
        gt_compl_boxes=rng.normal(size=(g, 8, 3)).astype(np.float32),
        gt_classes=rng.integers(0, 7, g).astype(np.int32))


@pytest.mark.parametrize("n,g", [(3, 2), (0, 2), (5, 0)])
def test_h5_round_trip_and_pad_sequence_match_jax(tmp_path, n, g):
    """Each package reads the other's file (gt_cls stored one-based, no
    detections stored as empty arrays); pad_sequence equal, with and
    without frame padding."""
    rng = np.random.default_rng(n * 10 + g)
    frames = [_frame(rng, n, g), _frame(rng, max(n - 1, 0), g)]
    for i, f in enumerate(frames):
        h5_t.write_frame_h5(str(tmp_path / "t" / f"{i}.h5"),
                            h5_t.FrameDetections(*f))
        h5_j.write_frame_h5(str(tmp_path / "j" / f"{i}.h5"), f)
    with h5py.File(tmp_path / "t" / "0.h5") as hf:
        np.testing.assert_array_equal(np.array(hf["gt_cls"]),
                                      frames[0].gt_classes + 1)
    back_t = [h5_t.read_frame_h5(str(tmp_path / "j" / f"{i}.h5"))
              for i in range(2)]
    back_j = [h5_j.read_frame_h5(str(tmp_path / "t" / f"{i}.h5"))
              for i in range(2)]
    _equal(back_t, back_j)
    for seq_len in (None, 4):
        _equal(h5_t.pad_sequence(back_t, 4, 3, seq_len=seq_len),
               h5_j.pad_sequence(back_j, 4, 3, seq_len=seq_len))


# ------------------------------------------------------------ evaluators


def _masks(rng, k, h=20, w=24):
    out = np.zeros((k, h, w), bool)
    for i in range(k):
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
        out[i, y0:y0 + rng.integers(2, 8), x0:x0 + rng.integers(2, 10)] = 1
    out[0, 0, 0] = True                       # a run that starts at 1
    return out


def test_rle_matches_jax():
    """encode/decode/area/merge/iou (with a crowd GT)/strings/bbox equal to
    the JAX package's (its native library where present)."""
    rng = np.random.default_rng(4)
    masks = _masks(rng, 6)
    rt = [rle_t.encode(m) for m in masks]
    rj = [rle_j.encode(m) for m in masks]
    _equal(rt, rj)
    for r, m in zip(rt, masks):
        _equal(rle_t.decode(r), m.astype(np.uint8))
        assert rle_t.area(r) == rle_j.area(r)
        s = rle_t.to_string(r)
        assert s == rle_j.to_string(r)
        _equal(rle_t.from_string(s, r["size"]), rle_j.from_string(s,
                                                                 r["size"]))
        _equal(rle_t.bbox(r), rle_j.bbox(r))
    for inter in (False, True):
        _equal(rle_t.merge(rt[:3], inter), rle_j.merge(rj[:3], inter))
    np.testing.assert_allclose(rle_t.iou(rt[:4], rt[2:], [0, 1, 0, 0]),
                               rle_j.iou(rj[:4], rj[2:], [0, 1, 0, 0]),
                               rtol=1e-12)


def test_coco_summarize_matches_jax():
    """COCOEvaluator over images with noisy, missing and spurious
    detections (bbox and segm, all area ranges): equal summaries."""
    rng = np.random.default_rng(5)
    evs = [coco_t.COCOEvaluator(3), coco_j.COCOEvaluator(3)]
    for _ in range(4):
        m = 5
        xy = rng.uniform(0, 200, (m, 2))
        gt = np.concatenate([xy, xy + rng.uniform(5, 120, (m, 2))], 1)
        dt = np.concatenate([gt + rng.normal(0, 3, gt.shape),
                             gt[:2] + rng.normal(0, 40, (2, 4))])
        dt[:, 2:] = np.maximum(dt[:, 2:], dt[:, :2] + 1)
        gt_cls = rng.integers(0, 3, m)
        dt_cls = np.concatenate([gt_cls, rng.integers(0, 3, 2)])
        dt_valid = rng.uniform(size=m + 2) < 0.9
        gm = np.zeros((m, 240, 320), bool)
        dm = np.zeros((m + 2, 240, 320), bool)
        for i, b in enumerate(gt.astype(int)):
            gm[i, b[1]:b[3], b[0]:b[2]] = True
        for i, b in enumerate(np.clip(dt, 0, 320).astype(int)):
            dm[i, b[1]:b[3], b[0]:b[2]] = True
        scores = rng.uniform(size=m + 2)
        for ev in evs:
            ev.add_image(dt, scores, dt_cls, dt_valid, gt, gt_cls,
                         np.ones(m, bool), dm, gm)
    got, want = evs[0].summarize(), evs[1].summarize()
    assert sorted(got) == sorted(want) and "segm/AP" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k


# ---------------------------------------------------- metrics and pose


def test_rotation_and_location_error_match_jax():
    rng = np.random.default_rng(6)
    euler = rng.uniform(-np.pi, np.pi, (2, 16, 3)).astype(np.float32)
    euler[1, :4] = euler[0, :4] + 1e-4       # near-identical rotations
    scale = rng.uniform(0.5, 2, (16, 1, 1)).astype(np.float32)
    ra = np.asarray(e2r_j(jnp.asarray(euler[0]))) * scale
    rb = np.asarray(e2r_j(jnp.asarray(euler[1])))
    got = metrics_t.rotation_error_deg(to_torch(ra), to_torch(rb))
    want = metrics_j.rotation_error_deg(jnp.asarray(ra), jnp.asarray(rb))
    # arccos near 0 amplifies float32 rounding: 1e-2 degrees there.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-2)
    loc = rng.normal(size=(2, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        metrics_t.location_error(to_torch(loc[0]), to_torch(loc[1])).numpy(),
        np.asarray(metrics_j.location_error(loc[0], loc[1])), rtol=RTOL,
        atol=ATOL)
    np.testing.assert_allclose(
        euler_to_rotmat(to_torch(euler[1])).numpy(), rb, atol=1e-6)


@pytest.mark.parametrize("box", [[3.2, 5.1, 60.3, 47.6],     # upsampling
                                 [10.3, 20.7, 22.1, 29.4],   # under 28 px
                                 [40.1, 40.2, 41.5, 80.3],   # thin, clipped
                                 [-6.4, 50.2, 20.3, 70.1]])  # off the edge
def test_paste_patch_matches_scale_and_translate(box):
    """The triangle-kernel weights with their anti-aliased width: equal to
    `jax.image.scale_and_translate(method='linear')` on boxes larger and
    smaller than the 28-px patch, including boxes partly off the image.
    (At an integer box edge the sample of the column just past the box
    lies exactly on the patch's border, where rounding decides and jitted
    and eager JAX disagree; the boxes here avoid it.)"""
    rng = np.random.default_rng(7)
    patch = rng.uniform(size=(28, 28, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, b: pipeline_j.paste_patch(
        p, b, (64, 72)))(patch, np.float32(box)))
    got = pipeline_t.paste_patch(to_torch(patch), to_torch(np.float32(box)),
                                 (64, 72))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    assert np.abs(want).sum() > 0
    batched = pipeline_t.paste_patch(to_torch(np.stack([patch, patch])),
                                     to_torch(np.float32([box, box])),
                                     (64, 72))
    np.testing.assert_allclose(batched.numpy(), np.stack([want, want]),
                               rtol=RTOL, atol=1e-6)


def test_crop_gt_box3d_matches_jax(trees):
    """GT boxes of a fixture frame cropped to the visible extent (incl. a
    slot whose mask sees nothing, which keeps the sorted box)."""
    dt = motfront_t.MOTFrontDataset(str(trees / "port"), "val")
    s = loader_t.load_frame(dt, dt.load_scene(dt.scenes()[0]).frames[1],
                            CFG_T.detection)
    masks = s.masks.copy()
    masks[1] = 0.0
    cam = CFG.camera
    k_j = intr_j(cam.fx, cam.fy, cam.cx, cam.cy)
    want = np.asarray(jax.jit(jax.vmap(
        lambda b3, b2, m: pipeline_j.crop_gt_box3d(
            jnp.asarray(s.depth), jnp.asarray(s.campose), k_j, b3, b2, m)))(
        s.boxes3d, s.boxes, masks))
    got = pipeline_t.crop_gt_box3d(
        to_torch(s.depth), to_torch(s.campose),
        make_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy), to_torch(s.boxes3d),
        to_torch(s.boxes), to_torch(masks))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not np.allclose(want[0], s.boxes3d[0])     # slot 0 was cropped
