"""The port's visualisation exports (isosurface, PLY/OBJ writers, shape
fusion, the replay page and the per-sequence export) and point-cloud
helpers against the JAX package's, on the CPU.  (The tracking trainer's `validate(export_dir=...)`
is compared with JAX's in test_torch_port_workflow.py, where JAX's
trainer is compiled already.)  Both sides are host numpy code, so the comparisons are exact: equal
arrays and byte-equal files.  One input is not numpy on the JAX side: a
detection's Euler angles become a float32 rotation matrix through XLA's
sin and cos, which differ from torch's (and from the correctly rounded
values) in the last bit for a few per cent of angles.  So the posed-shape
OBJs (`with_shapes`) compare their faces exactly and their vertices to
1.5e-5 (the printed 5 decimals, one rounding step either way), and the
replay page's embedded rotations to 1e-4 (printed to 4 decimals); every
other file is byte-equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from mot3d_tpu.tracking import isosurface as iso_j
from mot3d_tpu.tracking import replay as replay_j
from mot3d_tpu.tracking import visualise as vis_j
from mot3d_tpu.utils import pointcloud as pc_j
from mot3d_tpu_torch.tracking import isosurface as iso_t
from mot3d_tpu_torch.tracking import replay as replay_t
from mot3d_tpu_torch.tracking import visualise as vis_t
from mot3d_tpu_torch.utils import pointcloud as pc_t

torch.set_num_threads(1)


def _grid(seed, res=12, p=0.35):
    """A blobby occupancy grid: a smoothed random field thresholded."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(res, res, res))
    for ax in range(3):
        g = (g + np.roll(g, 1, ax) + np.roll(g, -1, ax)) / 3
    return (g > np.quantile(g, 1 - p)).astype(np.float32)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _replay_data(html: bytes):
    text = html.decode()
    start = text.index("const DATA = ") + len("const DATA = ")
    return json.loads(text[start:text.index(";\n", start)])


def _close_obj(a: bytes, b: bytes, what):
    la, lb = a.decode().splitlines(), b.decode().splitlines()
    assert len(la) == len(lb), what
    assert [x for x in la if x[0] == "f"] == [x for x in lb if x[0] == "f"]
    va = np.array([x.split()[1:] for x in la if x[0] == "v"], float)
    vb = np.array([x.split()[1:] for x in lb if x[0] == "v"], float)
    np.testing.assert_allclose(va, vb, rtol=0, atol=1.5e-5, err_msg=what)


def _assert_same_tree(a, b, posed=False):
    """Byte-equal trees; with `posed`, the files that carry an Euler
    rotation compare as the module docstring says."""
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    assert ta, "nothing written"
    for k in ta:
        if posed and k.startswith("shape_"):
            _close_obj(ta[k], tb[k], k)
        elif posed and k.endswith("replay.html"):
            da, db = _replay_data(ta[k]), _replay_data(tb[k])
            for tr_a, tr_b in zip(da["pred"], db["pred"]):
                for d in tr_a["dets"] + tr_b["dets"]:
                    d.setdefault("R", None)
                ra = [d.pop("R") for d in tr_a["dets"]]
                rb = [d.pop("R") for d in tr_b["dets"]]
                assert [r is None for r in ra] == [r is None for r in rb]
                np.testing.assert_allclose(
                    np.array([r for r in ra if r is not None]),
                    np.array([r for r in rb if r is not None]), rtol=0,
                    atol=1e-4, err_msg=k)
            assert da == db, k
        else:
            assert ta[k] == tb[k], k


@pytest.mark.parametrize("level", [0.5, 0.3])
def test_isosurface_matches_jax(level):
    assert np.array_equal(iso_t._TET_TABLE, iso_j._TET_TABLE)
    for seed in range(3):
        g = _grid(seed) * np.random.default_rng(seed).uniform(0.6, 1.0)
        for fn in ("marching_tetrahedra", "vox2mesh"):
            vt, ft = getattr(iso_t, fn)(g, level)
            vj, fj = getattr(iso_j, fn)(g, level)
            assert len(ft) > 0
            np.testing.assert_array_equal(vt, vj)
            np.testing.assert_array_equal(ft, fj)
    empty = np.zeros((8, 8, 8))
    for mod in (iso_t, iso_j):
        v, f = mod.vox2mesh(empty)
        assert v.shape == (0, 3) and f.shape == (0, 3)


def test_writers_and_fusion_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3))
    cols = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    grid = _grid(2, res=10)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    trans, scale = rng.normal(size=3), 0.7
    for name, mod in (("t", vis_t), ("j", vis_j)):
        d = tmp_path / name
        mod.write_ply(str(d / "a.ply"), pts, cols)
        mod.write_ply(str(d / "b.ply"), pts)
        mod.voxel_to_obj(str(d / "cubes.obj"), grid, rot, trans, scale)
        n = mod.voxel_to_mesh_obj(str(d / "mesh.obj"), grid, rot, trans,
                                  scale)
        assert n > 0
        assert mod.voxel_to_mesh_obj(str(d / "none.obj"), np.zeros_like(grid),
                                     rot, trans, scale) == 0
    _assert_same_tree(tmp_path / "t", tmp_path / "j")
    trajs = _trajectories(rng)
    shapes_t, scales_t = vis_t.fuse_obj_shape(trajs)
    shapes_j, scales_j = vis_j.fuse_obj_shape(trajs)
    assert scales_t == scales_j
    for a, b in zip(shapes_t, shapes_j):
        assert (a is None and b is None) or np.array_equal(a, b)


def _trajectories(rng, n=3, t=4, with_pose=True):
    """Trajectories as `Tracker.assemble` and the office path make them:
    scan_idx, loc, cls, and (office) box, voxel, euler, scale; the last
    one has no voxels."""
    out = []
    for i in range(n):
        traj = []
        for s in range(t):
            d = {"scan_idx": s, "obj_idx": i, "cls": i % 7,
                 "loc": rng.normal(size=3)}
            if with_pose and i < n - 1:
                d.update(voxel=_grid(10 * i + s, res=8, p=0.4),
                         euler=rng.uniform(-np.pi, np.pi, 3),
                         scale=float(rng.uniform(0.5, 1.5)),
                         box=rng.normal(size=(8, 3)))
            traj.append(d)
        out.append(traj)
    return out


@pytest.mark.parametrize("kw", [
    {}, {"with_shapes": True}, {"with_shapes": True, "fuse_shapes": True}],
    ids=["tracks", "shapes", "fused"])
def test_export_sequence_and_replay_match_jax(tmp_path, kw):
    rng = np.random.default_rng(2)
    trajs = _trajectories(rng)
    gt = _trajectories(rng, with_pose=False)
    bg = np.concatenate([rng.normal(size=(5000, 3)),
                         rng.integers(0, 256, (5000, 3))], 1)
    for name, mod in (("t", vis_t), ("j", vis_j)):
        mod.export_sequence(str(tmp_path / name), trajs, background_pc=bg,
                            gt_trajectories=gt, **kw)
    _assert_same_tree(tmp_path / "t", tmp_path / "j",
                      posed=bool(kw.get("with_shapes")))
    for name, mod in (("t", replay_t), ("j", replay_j)):
        mod.write_replay_html(str(tmp_path / f"{name}.html"), trajs,
                              seq_len=6)
    assert (tmp_path / "t.html").read_bytes() == \
        (tmp_path / "j.html").read_bytes()


def test_pointcloud_helpers_match_jax():
    rng = np.random.default_rng(4)
    grid = _grid(5, res=16)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0] * 1.3
    trans = rng.normal(size=3)
    depth = rng.uniform(0.5, 3.0, (12, 16))
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    rgb = rng.integers(0, 256, (12, 16, 3)).astype(np.float64)
    mask = rng.uniform(size=depth.shape) < 0.5
    intr = np.array([[20.0, 0, 7.5], [0, 21.0, 5.5], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = rot / 1.3, trans
    for name, args in (
            ("get_scale", (rot,)),
            ("convert_voxel_to_pc", (grid, rot, trans, 0.8)),
            ("construct_box_minmax", (rng.normal(size=(30, 3)),)),
            ("backproject_rgb", (rgb, depth, intr)),
            ("rgb_image_to_world_pc", (rgb, depth, pose, intr)),
            ("project_segmask_world", (mask, depth, pose, intr))):
        got, want = getattr(pc_t, name)(*args), getattr(pc_j, name)(*args)
        assert np.asarray(got).size > 0, name
        np.testing.assert_array_equal(got, want, err_msg=name)
