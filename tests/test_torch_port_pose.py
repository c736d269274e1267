"""Parity of the port's pose stage (mot3d_tpu_torch.pose and the K2 kernel's
plain version) against the JAX package, on the CPU.

Tolerances: extraction feats atol 2e-5 (the two frameworks associate the
2 x 2 bilinear taps differently; values are O(1)), valid exact.  Pose
outputs: valid and classes exact; translations, scales, euler angles and
world boxes within 1e-4 (float32 moments of ~100 points, a power-iterated
eigenvector, and a trigonometric decomposition).  The scene is built so
every fit is well posed: NOCS is an exact similarity image of the depth
surface, so the RANSAC winner is never a near-tie.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mot3d_tpu.geometry.backproject import make_intrinsics as intr_j
from mot3d_tpu.geometry.transforms import euler_to_rotmat
from mot3d_tpu.ops.pallas import pose_extract as pe_j
from mot3d_tpu.pose.extraction import grid_extract as grid_j
from mot3d_tpu.pose.pipeline import postprocess_frame as post_j
from mot3d_tpu_torch.pose.extraction import grid_extract as grid_t
from mot3d_tpu_torch.pose.pipeline import postprocess_frame as post_t
from torch_port_helpers import port_config, slot_draws, to_torch

torch.set_num_threads(1)


def _frame(d_count=4, h=64, w=64, seed=0):
    """The 64x64 frames of tests/test_pose_extract_pallas.py."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.5, 3.0, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = 0.0
    boxes = []
    for _ in range(d_count):
        x0 = rng.uniform(0, w - 12)
        y0 = rng.uniform(0, h - 12)
        boxes.append([x0, y0, x0 + rng.uniform(8, w - x0),
                      y0 + rng.uniform(8, h - y0)])
    boxes = np.asarray(boxes, np.float32)
    nocs = rng.uniform(0, 1, (d_count, 28, 28, 3)).astype(np.float32)
    masks = (rng.uniform(size=(d_count, 28, 28)) > 0.3).astype(np.float32)
    intr = np.array([[64.0, 0, 31.5], [0, 64.0, 31.5], [0, 0, 1]],
                    np.float32)
    return nocs, masks, boxes, depth, intr


def _jax_grid(nocs, masks, boxes, depth, intr):
    return jax.jit(jax.vmap(lambda n, m, b: grid_j(
        n, m, b, jnp.asarray(depth), jnp.asarray(intr), grid=32)))(
        jnp.asarray(nocs), jnp.asarray(masks), jnp.asarray(boxes))


def _pallas_interpret():
    """`postprocess_frame` calls the Pallas kernel without `interpret`; on
    the CPU it must run interpreted (the pattern of tests/test_ops.py)."""
    orig = pe_j.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    return mock.patch.object(pe_j.pl, "pallas_call", interp)


@pytest.mark.parametrize("seed", [0, 1, "outside"])
def test_grid_extract_matches_jax_grid_and_pallas(seed):
    if seed == "outside":
        nocs, masks, boxes, depth, intr = _frame(d_count=2)
        boxes[0] = [-10.0, -10.0, 30.0, 30.0]
        boxes[1] = [40.0, 40.0, 90.0, 90.0]
    else:
        nocs, masks, boxes, depth, intr = _frame(seed=seed)
    feats_t, valid_t = grid_t(*map(to_torch, (nocs, masks, boxes, depth,
                                              intr)), grid=32)
    feats_x, valid_x = _jax_grid(nocs, masks, boxes, depth, intr)
    feats_p, valid_p = pe_j.pose_extract_pallas(
        *map(jnp.asarray, (nocs, masks, boxes, depth, intr)), grid=32,
        interpret=True)
    for feats_j, valid_j in ((feats_x, valid_x), (feats_p, valid_p)):
        np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
        np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j),
                                   atol=2e-5, rtol=0)
    assert np.isfinite(feats_t.numpy()).all()


def test_grid_extract_batched_over_frames():
    """(F, H, W) depth with slots grouped per frame equals one call per
    frame: the layout the K2 kernel consumes for a whole sequence."""
    frames = [_frame(d_count=3, seed=s) for s in (4, 5)]
    stacked = [np.concatenate([f[i] for f in frames]) for i in range(3)]
    depth = np.stack([f[3] for f in frames])
    feats, valid = grid_t(*map(to_torch, stacked), to_torch(depth),
                          to_torch(frames[0][4]), grid=16)
    for i, f in enumerate(frames):
        fi, vi = grid_t(*map(to_torch, f), grid=16)
        np.testing.assert_array_equal(feats[3 * i:3 * i + 3].numpy(),
                                      fi.numpy())
        np.testing.assert_array_equal(valid[3 * i:3 * i + 3].numpy(),
                                      vi.numpy())


def _scene(seed=0, h=64, w=64, fx=64.0):
    """One frame whose NOCS patches are exact similarity images of the depth
    surface seen through each box, plus GT boxes that gate and clean."""
    rng = np.random.default_rng(seed)
    cx = cy = (w - 1) / 2

    def depth_at(u, v):
        return 2.0 + 0.3 * u / w + 0.2 * v / h

    def cam(u, v):
        d = depth_at(u, v)
        return np.stack([(u - cx) / fx * d, -((v - cy) / fx * d), -d], -1)

    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    depth = depth_at(uu, vv).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.05] = 0.0

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(euler_to_rotmat(jnp.asarray([0.2, -0.3, 0.1])))
    pose[:3, 3] = [0.5, 1.0, -0.2]

    boxes = np.array([[5.3, 7.1, 35.6, 40.2], [30.2, 20.7, 60.4, 55.9],
                      [12.8, 30.3, 40.1, 58.6], [-6.4, 40.2, 20.3, 70.1]],
                     np.float32)
    p = 28
    nocs = np.zeros((4, p, p, 3), np.float32)
    world_boxes = []
    for i, (x0, y0, x1, y1) in enumerate(boxes):
        j = (np.arange(p) + 0.5) / p
        xs, ys = np.meshgrid(x0 + j * (x1 - x0) - 0.5, y0 + j * (y1 - y0) - 0.5)
        pts = cam(xs, ys)
        rot = np.asarray(euler_to_rotmat(jnp.asarray(
            rng.uniform(-0.6, 0.6, 3).astype(np.float32))), np.float64)
        scale = rng.uniform(1.2, 2.0)
        t = pts.reshape(-1, 3).mean(0)
        nocs[i] = ((pts - t) @ rot) / scale + 0.5   # pts = s R (n - .5) + t
        world = pts.reshape(-1, 3) @ pose[:3, :3].T + pose[:3, 3]
        world_boxes.append((world.min(0), world.max(0)))
    masks = np.full((4, p, p), 0.85, np.float32)
    masks[:, :5, :7] = 0.15

    gt2d = boxes[:3] + np.float32([0.7, -0.4, 0.9, 0.3])
    gt3d = []
    for i, (lo, hi) in enumerate(world_boxes[:3]):
        if i == 0:   # a GT box that cuts the object: cleaning applies
            hi = lo + 0.7 * (hi - lo)
        signs = np.array([[1, 1, 1], [1, 1, -1], [-1, 1, -1], [-1, 1, 1],
                          [1, -1, 1], [1, -1, -1], [-1, -1, -1],
                          [-1, -1, 1]], np.float32)
        gt3d.append((lo + hi) / 2 + signs * (hi - lo) / 2 * 1.05)
    return dict(
        det_boxes=boxes, det_scores=np.float32([0.9, 0.8, 0.2, 0.95]),
        det_classes=np.int32([0, 3, 1, 2]),
        det_valid=np.array([True, True, True, True]),
        det_masks=masks,
        det_voxels=rng.uniform(size=(4, 32, 32, 32)).astype(np.float32),
        det_nocs=nocs.astype(np.float32), gt_boxes2d=gt2d,
        gt_valid=np.array([True, True, True]), depth=depth, campose=pose,
        gt_boxes3d_cropped=np.stack(gt3d).astype(np.float32))


@pytest.mark.parametrize("extraction", ["grid", "pallas"])
@pytest.mark.parametrize("use_gt_gate", [True, False])
def test_postprocess_frame_matches_jax(extraction, use_gt_gate):
    cfg_j = _tiny_config()
    cfg_j = cfg_j.replace(pose=cfg_j.pose.__class__(
        **{**cfg_j.pose.__dict__, "extraction": extraction}))
    cfg_t = port_config(cfg_j)
    sc = _scene()
    intr = intr_j(64.0, 64.0, 31.5, 31.5)
    key = jax.random.PRNGKey(3)
    names = ("det_boxes", "det_scores", "det_classes", "det_valid",
             "det_masks", "det_voxels", "det_nocs", "gt_boxes2d", "gt_valid",
             "depth", "campose")
    with _pallas_interpret():
        out_j = jax.jit(lambda *a: post_j(*a, cfg_j, use_gt_gate=use_gt_gate))(
            *(jnp.asarray(sc[n]) for n in names), intr,
            jnp.asarray(sc["gt_boxes3d_cropped"]), key)
    draws = slot_draws(key, 4, cfg_j.pose.ransac_iters,
                       cfg_j.pose.ransac_sample_size)
    out_t = post_t(*(to_torch(sc[n]) for n in names), to_torch(intr),
                   to_torch(sc["gt_boxes3d_cropped"]), cfg_t,
                   use_gt_gate=use_gt_gate, draws=to_torch(draws))

    assert np.asarray(out_j.valid).sum() >= 2  # the fits really ran
    for name in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)),
                                      err_msg=name)
    for name in ("translations", "scales", "rotations", "pred_boxes",
                 "objectness", "voxels"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
