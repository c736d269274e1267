"""Parity of the port's geometry core (mot3d_tpu_torch.geometry, ops.segment
and the K1 kernel's plain version) against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both frameworks as numpy arrays.
Tolerances: 1e-5 for closed-form float32 geometry (a few roundings of
order-1 values); 1e-4 for fits that go through a RANSAC winner and a
power-iterated eigenvector; exact equality for masks and selections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mot3d_tpu.geometry import iou3d as iou_j
from mot3d_tpu.geometry import transforms as tf_j
from mot3d_tpu.geometry import umeyama as um_j
from mot3d_tpu.geometry.outlier import statistical_outlier_mask as som_j
from mot3d_tpu.ops import segment as seg_j
from mot3d_tpu_torch.geometry import iou3d as iou_t
from mot3d_tpu_torch.geometry import transforms as tf_t
from mot3d_tpu_torch.geometry import umeyama as um_t
from mot3d_tpu_torch.geometry.outlier import statistical_outlier_mask as som_t
from mot3d_tpu_torch.ops import segment as seg_t

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def test_euler_rotmat_quaternion_roundtrip():
    rng = np.random.default_rng(0)
    euler = rng.uniform(-np.pi, np.pi, (16, 3)).astype(np.float32)
    euler[0] = [0.3, np.pi / 2, -0.2]           # gimbal pole
    r_j = tf_j.euler_to_rotmat(jnp.asarray(euler))
    r_t = tf_t.euler_to_rotmat(_t(euler))
    _close(r_t, r_j, 1e-6)
    _close(tf_t.rotmat_to_euler(r_t), tf_j.rotmat_to_euler(r_j), 1e-5)
    _close(tf_t.quaternion_from_euler(_t(euler)),
           tf_j.quaternion_from_euler(jnp.asarray(euler)), 1e-6)


def test_cam_to_world_aabb_and_sort_bbox():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(tf_j.euler_to_rotmat(jnp.asarray([0.1, 0.7,
                                                                -0.4])))
    pose[:3, 3] = [1.0, -2.0, 0.5]
    _close(tf_t.cam_to_world(_t(pts), _t(pose)),
           tf_j.cam_to_world(jnp.asarray(pts), jnp.asarray(pose)), 1e-5)
    mins = rng.normal(size=(6, 3)).astype(np.float32)
    maxs = mins + rng.uniform(0.1, 2.0, (6, 3)).astype(np.float32)
    box_t = tf_t.aabb_corners(_t(mins), _t(maxs))
    _close(box_t, np.stack([np.asarray(tf_j.aabb_corners(
        jnp.asarray(a), jnp.asarray(b))) for a, b in zip(mins, maxs)]), 1e-6)
    # Shuffled corners come back in the canonical order, as in JAX.
    shuffled = np.stack([b[rng.permutation(8)]
                         for b in box_t.numpy()]).astype(np.float32)
    out_t = tf_t.sort_bbox(_t(shuffled)).numpy()
    out_j = np.stack([np.asarray(tf_j.sort_bbox(jnp.asarray(b)))
                      for b in shuffled])
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(out_t, box_t.numpy())


def test_iou_matrices():
    rng = np.random.default_rng(2)
    b1 = rng.uniform(0, 50, (7, 2)).astype(np.float32)
    b1 = np.concatenate([b1, b1 + rng.uniform(1, 30, (7, 2))], 1
                        ).astype(np.float32)
    b2 = np.concatenate([b1[:3] + 2.0, b1[3:5] * 0.5 + 20.0], 0)
    _close(iou_t.box2d_iou_matrix(_t(b1), _t(b2)),
           iou_j.box2d_iou_matrix(jnp.asarray(b1), jnp.asarray(b2)), 1e-6)

    def boxes(n, seed):
        r = np.random.default_rng(seed)
        mins = r.uniform(-1, 1, (n, 3)).astype(np.float32)
        maxs = mins + r.uniform(0.3, 1.5, (n, 3)).astype(np.float32)
        corners = np.asarray(tf_j.aabb_corners(jnp.asarray(mins)[:, None],
                                               jnp.asarray(maxs)[:, None]))
        # Rotate about y around the box centre: the BEV quads are then
        # general convex quads, not axis-aligned rectangles.
        ang = r.uniform(-0.8, 0.8, n)
        c, s = np.cos(ang), np.sin(ang)
        rot = np.stack([np.stack([c, 0 * c, s], -1),
                        np.stack([0 * c, 1 + 0 * c, 0 * c], -1),
                        np.stack([-s, 0 * c, c], -1)], -2)
        ctr = corners.mean(1, keepdims=True)
        return (np.einsum("nij,nkj->nki", rot, corners - ctr) + ctr
                ).astype(np.float32)

    g1, g2 = boxes(6, 3), boxes(5, 4)
    # Near-identical and overlapping pairs.  (An exactly identical pair is
    # degenerate for the strict inside test: every vertex lies on a clip
    # line, and the result then depends on rounding in both frameworks.)
    g2[0] = g1[0] + np.float32([0.01, 0.02, -0.015])
    g2[1] = g1[1] + np.float32([0.2, 0.1, -0.15])
    got = iou_t.box3d_iou_matrix(_t(g1), _t(g2))
    want = jax.jit(iou_j.box3d_iou_matrix)(jnp.asarray(g1), jnp.asarray(g2))
    _close(got, want, 1e-5)
    assert np.asarray(want)[0, 0] > 0.8 and np.asarray(want)[1, 1] > 0.1


@pytest.mark.parametrize("masked", [False, True])
def test_segment_ops(masked):
    rng = np.random.default_rng(5)
    data = rng.normal(size=(40, 6)).astype(np.float32)
    ids = rng.integers(0, 9, 40).astype(np.int32)  # segment 9 stays empty
    mask = rng.uniform(size=40) > 0.4 if masked else None
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else _t(mask)
    for fj, ft in ((seg_j.segment_sum, seg_t.segment_sum),
                   (seg_j.segment_mean, seg_t.segment_mean),
                   (seg_j.segment_max, seg_t.segment_max)):
        _close(ft(_t(data), _t(ids), 10, mt),
               fj(jnp.asarray(data), jnp.asarray(ids), 10, mj), 1e-5)


def _fit_problem(seed, n=300, n_valid=260, outliers=25):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    rot = np.asarray(tf_j.euler_to_rotmat(jnp.asarray(
        rng.uniform(-1, 1, 3).astype(np.float32))))
    scale, trans = 1.7, np.float32([0.3, -1.2, -2.5])
    tgt = (scale * src @ rot.T + trans
           + rng.normal(0, 0.003, (n, 3))).astype(np.float32)
    tgt[:outliers] += rng.normal(0, 0.8, (outliers, 3)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    return src, tgt, valid


@pytest.mark.parametrize("method", ["quat", "svd"])
def test_umeyama_similarity(method):
    src, tgt, valid = _fit_problem(6)
    w = valid.astype(np.float32)
    fj = um_j.umeyama_similarity(jnp.asarray(src), jnp.asarray(tgt),
                                 jnp.asarray(w), method)
    ft = um_t.umeyama_similarity(_t(src), _t(tgt), _t(w), method)
    for name in ("scale", "rotation", "translation"):
        _close(getattr(ft, name), getattr(fj, name), 1e-4)


@pytest.mark.parametrize("method", ["quat", "svd"])
def test_estimate_similarity_transform_with_injected_draws(method):
    src, tgt, valid = _fit_problem(7)
    key = jax.random.PRNGKey(11)
    iters, sample = 24, 10
    draws = np.asarray(jax.random.randint(key, (iters, sample), 0,
                                          jnp.iinfo(jnp.int32).max))
    fj = jax.jit(lambda s, t, v, k: um_j.estimate_similarity_transform(
        s, t, v, k, iters, sample, method=method))(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), key)
    ft = um_t.estimate_similarity_transform(
        _t(src), _t(tgt), _t(valid), _t(draws.astype(np.int64)),
        method=method)
    assert bool(ft.valid) == bool(fj.valid)
    for name in ("scale", "rotation", "translation"):
        _close(getattr(ft, name), getattr(fj, name), 1e-4)
    # The injected draws also pin the RANSAC inlier set itself.
    pass_t = jnp.float32(3.0)
    inl_j, _ = jax.jit(lambda s, t, v, k: um_j.ransac_umeyama(
        s, t, v, k, iters, sample, pass_t, pass_t / 100, method))(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), key)
    inl_t, _ = um_t.ransac_umeyama(_t(src), _t(tgt), _t(valid),
                                   _t(draws.astype(np.int64)),
                                   torch.tensor(3.0), torch.tensor(0.03),
                                   method)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))


RNG = np.random.default_rng(0)


def _outlier_cases():
    cluster = RNG.normal(size=(900, 3)).astype(np.float32) * 0.1
    outl = RNG.normal(size=(24, 3)).astype(np.float32) * 0.1
    outl += np.sign(outl) * 4.0
    subset = (np.concatenate([cluster, outl, np.zeros((100, 3), np.float32)]),
              np.concatenate([np.ones(924, bool), np.zeros(100, bool)]), 256)
    full = RNG.normal(size=(256, 3)).astype(np.float32)
    full[200:] *= 8.0
    padded = np.concatenate([RNG.normal(size=(150, 3)).astype(np.float32)
                             * 0.1, np.full((50, 3), 1e6, np.float32)])
    return {"subset": subset, "full": (full, np.ones(256, bool), 0),
            "padded": (padded, np.concatenate([np.ones(150, bool),
                                               np.zeros(50, bool)]), 64)}


@pytest.mark.parametrize("case", ["subset", "full", "padded"])
def test_knn_outlier_plain_matches_jax_xla_and_pallas(case):
    """K1's plain version (the CPU path of `knn_mean_dists`) against the
    exact XLA path and the Pallas kernel in interpret mode: kept masks
    equal, mean-kNN within 1e-5."""
    pts, valid, cand = _outlier_cases()[case]
    keep_t = som_t(_t(pts), _t(valid), min_points=10, candidates=cand)
    for impl, kw in (("xla", {"approx": False}), ("pallas_interpret", {})):
        keep_j = jax.jit(lambda p, v: som_j(
            p, v, min_points=10, candidates=cand, impl=impl, **kw))(
            jnp.asarray(pts), jnp.asarray(valid))
        np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j),
                                      err_msg=impl)

    from mot3d_tpu.ops.pallas.knn_outlier import knn_mean_dists_pallas
    from mot3d_tpu_torch.geometry.outlier import candidate_columns
    from mot3d_tpu_torch.ops.cuda.knn_outlier import knn_mean_dists
    cols, k = candidate_columns(len(pts), cand, 20)
    got = knn_mean_dists(_t(pts)[None], _t(valid)[None], cols, k)[0]
    cj = jnp.asarray(cols.numpy())
    want = knn_mean_dists_pallas(jnp.asarray(pts), jnp.asarray(pts)[cj],
                                 jnp.asarray(valid)[cj], cj, k,
                                 interpret=True)
    v = valid
    # The expanded d2 cancels: its rounding grows with |p|^2, so the
    # 4-unit outliers carry a relative, not an absolute, 1e-5.
    np.testing.assert_allclose(got.numpy()[v], np.asarray(want)[v],
                               rtol=1e-5, atol=1e-5)


def test_knn_outlier_batched_matches_vmapped_jax():
    pts = RNG.normal(size=(3, 256, 3)).astype(np.float32)
    pts[:, 240:] *= 10.0
    valid = np.ones((3, 256), bool)
    valid[2, :200] = False                       # fewer than min_points
    f = jax.vmap(lambda p, v: som_j(p, v, min_points=10, candidates=64,
                                    approx=False, impl="xla"))
    want = np.asarray(f(jnp.asarray(pts), jnp.asarray(valid)))
    got = som_t(_t(pts), _t(valid), min_points=100, candidates=64).numpy()
    want_100 = np.asarray(jax.vmap(lambda p, v: som_j(
        p, v, min_points=100, candidates=64, approx=False, impl="xla"))(
        jnp.asarray(pts), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want_100)
    got10 = som_t(_t(pts), _t(valid), min_points=10, candidates=64).numpy()
    np.testing.assert_array_equal(got10, want)
