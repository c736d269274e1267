"""Trajectory smoothing, the reference's `fuse_pose` (counterpart of
`mot3d_tpu/tracking/smoothing.py`).

Mirrors `Tracking/utils/vis_utils.py:82-198`: per trajectory, rotations are
Slerp-interpolated and smoothed, translations and yaw are gaussian-filtered
over time, and shapes and boxes are filled forward.  Host numpy; scipy is
imported inside the functions, so importing the package does not load it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def fuse_pose(trajectory: List[dict], sigma_translation: float = 1.0,
              sigma_rotation: float = 1.0,
              seq_len: Optional[int] = None) -> List[dict]:
    """Smooth one trajectory (list of {scan_idx, loc, euler?, ...}).

    - translations: gaussian_filter1d over the track's own timeline;
    - rotations (if 'euler' present): Slerp onto every frame between first
      and last observation, then yaw smoothing;
    - other keys are filled forward for interpolated frames.
    Returns a new, densified trajectory covering every scan index between
    the first and last observation.
    """
    from scipy.ndimage import gaussian_filter1d
    from scipy.spatial.transform import Rotation, Slerp

    if len(trajectory) < 2:
        return list(trajectory)
    traj = sorted(trajectory, key=lambda d: d["scan_idx"])
    # One detection per frame (duplicate times would break Slerp/interp).
    seen: set = set()
    traj = [d for d in traj
            if d["scan_idx"] not in seen and not seen.add(d["scan_idx"])]
    if len(traj) < 2:
        return list(traj)
    times = np.array([d["scan_idx"] for d in traj], np.float64)
    locs = np.stack([np.asarray(d["loc"], np.float64) for d in traj])

    full_t = np.arange(int(times[0]), int(times[-1]) + 1)
    interp_locs = np.stack([
        np.interp(full_t, times, locs[:, k]) for k in range(3)], axis=1)
    smooth_locs = gaussian_filter1d(interp_locs, sigma_translation, axis=0)

    have_rot = "euler" in traj[0]
    if have_rot:
        rots = Rotation.from_euler(
            "xyz", np.stack([np.asarray(d["euler"]) for d in traj]))
        slerp = Slerp(times, rots)
        interp = slerp(full_t)
        eulers = interp.as_euler("xyz")
        # Yaw smoothing (the reference smooths the y rotation channel).
        eulers[:, 1] = gaussian_filter1d(eulers[:, 1], sigma_rotation)

    out = []
    src_idx = 0
    for k, t in enumerate(full_t):
        while src_idx + 1 < len(traj) and traj[src_idx + 1]["scan_idx"] <= t:
            src_idx += 1
        det = dict(traj[src_idx])  # fill-forward everything else
        det["scan_idx"] = int(t)
        det["loc"] = smooth_locs[k]
        if have_rot:
            det["euler"] = eulers[k]
        out.append(det)
    return out


def fuse_trajectories(trajectories: List[List[dict]], **kw) -> List[List[dict]]:
    return [fuse_pose(t, **kw) for t in trajectories]


def _unscale(mat3: np.ndarray):
    """Split a scaled rotation into (rotation, per-column scale)
    (`vis_utils.py:77-80,115-121`)."""
    scale = np.linalg.norm(mat3, axis=0)
    return mat3 / scale, scale


def fuse_pose_f2f(trajectory: List[dict], sigma: float = 3.0,
                  constraint: bool = True,
                  yaw_clip_frac: float = 0.2) -> List[dict]:
    """F2F smoothing variant (`Tracking/utils/vis_utils.py:201-318`
    fuse_pose_F2F): operates on scaled `cad2world` 4x4 matrices.

    Per trajectory: translations fill-forward + gaussian(sigma) per channel;
    rotations unscaled, Slerp onto every frame, yaw (z euler — MOTFront
    world space is z-up, matching the reference's F2F choice of
    channel -1 and zeroing x/y under `constraint`) gaussian(sigma)
    smoothed and clipped to a +/- yaw_clip_frac*|yaw0| band around the
    initial yaw; the per-frame scale re-multiplies the rotation; every
    other key fills forward, and 'loc'/'euler' are kept in sync with the
    rebuilt cad2world.

    Deliberate deviations from `vis_utils.py:295-304` (documented because
    both are latent bugs there): the reference's clip bounds
    (y0 -/+ frac*y0) invert for negative initial yaw, collapsing the whole
    series to one bound — we use |y0|; and the reference recomposes as
    diag(s) @ R although its own decomposition was R @ diag(s) — we
    recompose consistently (identical for the isotropic scales the pose
    solver produces).
    """
    from scipy.ndimage import gaussian_filter1d
    from scipy.spatial.transform import Rotation, Slerp

    if len(trajectory) < 2:
        return list(trajectory)
    traj = sorted(trajectory, key=lambda d: d["scan_idx"])
    # One detection per frame: a heuristic track can briefly hold two
    # same-frame entries; duplicate times would break Slerp.
    seen: set = set()
    traj = [d for d in traj
            if d["scan_idx"] not in seen and not seen.add(d["scan_idx"])]
    if len(traj) < 2:
        return list(traj)
    key_times = np.array([d["scan_idx"] for d in traj], np.float64)
    full_t = np.arange(int(key_times[0]), int(key_times[-1]) + 1)

    rots, scales, trans = [], {}, {}
    for d in traj:
        c2w = np.asarray(d["cad2world"], np.float64)
        r, s = _unscale(c2w[:3, :3])
        rots.append(r)
        scales[d["scan_idx"]] = s
        trans[d["scan_idx"]] = c2w[:3, 3]

    # Fill-forward translations/scales to every frame, then smooth.
    t_trans, t_scale, last_tr, last_sc = [], [], None, None
    for t in full_t:
        last_tr = trans.get(int(t), last_tr)
        last_sc = scales.get(int(t), last_sc)
        t_trans.append(last_tr)
        t_scale.append(last_sc)
    t_trans = gaussian_filter1d(np.stack(t_trans), sigma, axis=0)

    slerp = Slerp(key_times, Rotation.from_matrix(np.stack(rots)))
    eulers = slerp(full_t).as_euler("xyz")
    eulers[:, -1] = gaussian_filter1d(eulers[:, -1], sigma)
    y0 = eulers[0, -1]
    band = yaw_clip_frac * abs(y0)
    eulers[:, -1] = np.clip(eulers[:, -1], y0 - band, y0 + band)
    if constraint:
        eulers[:, 0] = 0.0
        eulers[:, 1] = 0.0
    rotmats = Rotation.from_euler("xyz", eulers).as_matrix()

    out, src_idx = [], 0
    for k, t in enumerate(full_t):
        while src_idx + 1 < len(traj) and traj[src_idx + 1]["scan_idx"] <= t:
            src_idx += 1
        det = dict(traj[src_idx])  # fill-forward voxels/boxes/ids/...
        det["scan_idx"] = int(t)
        c2w = np.identity(4)
        c2w[:3, :3] = rotmats[k] @ np.diag(t_scale[k])
        c2w[:3, 3] = t_trans[k]
        det["cad2world"] = c2w
        # Keep the flat pose fields consistent with the smoothed matrix:
        # downstream exports read 'loc'/'euler', not the matrix.
        det["loc"] = t_trans[k]
        det["euler"] = eulers[k].copy()
        det["scale"] = float(np.mean(t_scale[k]))
        out.append(det)
    return out
