"""Sequence visualisation exports (file-based; no GUI dependencies;
counterpart of `mot3d_tpu/tracking/visualise.py`).

Replaces the reference's dvis-based 4D replay (`Tracking/visualise/
visualise.py:13-726`) with portable artefacts: PLY point clouds for scene
backgrounds and posed object shapes, per-frame trajectory polylines,
isosurface meshes (vox2mesh parity via marching tetrahedra,
`mot3d_tpu_torch.tracking.isosurface`), a cube-per-voxel OBJ fallback, and a
self-contained interactive HTML replay (`mot3d_tpu_torch.tracking.replay`).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from mot3d_tpu_torch.geometry.transforms import euler_to_rotmat


def _rotmat(euler) -> np.ndarray:
    """Euler angles -> rotation matrix, in float32 as the JAX package
    computes it (`geometry/transforms.py:euler_to_rotmat`)."""
    return euler_to_rotmat(torch.as_tensor(
        np.asarray(euler), dtype=torch.float32)).numpy()


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point cloud; colors in [0, 255] uint8 (N, 3)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.5f} {points[i, 1]:.5f} {points[i, 2]:.5f}"
            if colors is not None:
                c = colors[i].astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")


def voxel_to_obj(path: str, grid: np.ndarray, rot: np.ndarray,
                 trans: np.ndarray, scale: float) -> None:
    """Posed occupancy grid -> OBJ of unit cubes (one per occupied voxel),
    replacing the reference's vox2mesh marching-cubes export."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    res = grid.shape[0]
    occ = np.stack(np.nonzero(grid), 1).astype(np.float64)
    cell = 1.0 / res
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                        for z in (0, 1)], np.float64) * cell
    faces = np.array([
        [0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1],
        [2, 3, 7, 6], [0, 2, 6, 4], [1, 5, 7, 3]])
    with open(path, "w") as f:
        base = 1
        m = (np.eye(3) * scale) @ np.asarray(rot)
        for v in occ:
            local = (v[None] * cell + corners) - 0.5
            world = local @ m.T + np.asarray(trans)
            for p in world:
                f.write(f"v {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
            for face in faces:
                idx = face + base
                f.write(f"f {idx[0]} {idx[1]} {idx[2]} {idx[3]}\n")
            base += 8


def voxel_to_mesh_obj(path: str, grid: np.ndarray, rot: np.ndarray,
                      trans: np.ndarray, scale: float,
                      level: float = 0.5) -> int:
    """Posed occupancy grid -> smooth isosurface OBJ (the reference's
    vox2mesh + world transform, `Tracking/visualise/visualise.py:592-617`).
    Returns the number of faces written (0 = empty grid, no file)."""
    from mot3d_tpu_torch.tracking.isosurface import vox2mesh
    verts, faces = vox2mesh(np.asarray(grid, np.float64), level)
    if len(faces) == 0:
        return 0
    world = verts @ (np.asarray(rot, np.float64) * scale).T \
        + np.asarray(trans, np.float64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for p in world:
            f.write(f"v {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")
    return len(faces)


_COLORS = np.array([
    [228, 26, 28], [55, 126, 184], [77, 175, 74], [152, 78, 163],
    [255, 127, 0], [255, 255, 51], [166, 86, 40], [247, 129, 191],
], np.uint8)


def fuse_obj_shape(trajectories: List[List[dict]]):
    """Canonical-space shape fusion (`fuse_obj_shape`,
    `Tracking/visualise/visualise.py:619-641`): each tracklet's per-frame
    32^3 voxel grids are accumulated in canonical (CAD) space by averaging
    and re-binarised at 0.5, and its scales are averaged — the replay then
    shows ONE fused shape per object, posed per frame, instead of a
    different reconstruction every frame.

    Returns (fused_shapes, fused_scales); a trajectory without voxels gets
    (None, mean-or-1.0 scale).
    """
    shapes, scales = [], []
    for traj in trajectories:
        grids = [np.asarray(d["voxel"], np.float64) for d in traj
                 if d.get("voxel") is not None]
        shapes.append((np.mean(grids, axis=0) >= 0.5) if grids else None)
        svals = [float(d["scale"]) for d in traj if "scale" in d]
        scales.append(float(np.mean(svals)) if svals else 1.0)
    return shapes, scales


def export_sequence(out_dir: str, trajectories: List[List[dict]],
                    background_pc: Optional[np.ndarray] = None,
                    with_shapes: bool = False,
                    gt_trajectories: Optional[List[List[dict]]] = None,
                    replay: bool = True,
                    fuse_shapes: bool = False) -> None:
    """Write trajectory polyline PLYs (+ posed voxel shapes when detections
    carry 'voxel'/'euler'/'scale'), mirroring visualise_pred_sequence, and
    an interactive replay.html (dvis 4D replay equivalent).

    `fuse_shapes` enables canonical-shape fusion (fuse_obj_shape,
    `Tracking/visualise/visualise.py:619-699`): every frame of a tracklet
    replays the SAME fused mesh (written once as fused_shape_<i>.obj) at
    the fused scale, and the replay.html gets the fused point sets too."""
    os.makedirs(out_dir, exist_ok=True)
    fused_grids = fused_scales = None
    if fuse_shapes:
        fused_grids, fused_scales = fuse_obj_shape(trajectories)
    if replay:
        from mot3d_tpu_torch.tracking.replay import write_replay_html
        write_replay_html(os.path.join(out_dir, "replay.html"), trajectories,
                          gt_trajectories=gt_trajectories,
                          background_pc=background_pc,
                          fused_shapes=fused_grids,
                          fused_scales=fused_scales)
    if background_pc is not None:
        pts = background_pc[:, :3]
        col = (background_pc[:, 3:6].astype(np.uint8)
               if background_pc.shape[1] >= 6 else None)
        write_ply(os.path.join(out_dir, "background.ply"), pts, col)
    for i, traj in enumerate(trajectories):
        locs = np.stack([np.asarray(d["loc"]) for d in traj])
        col = np.tile(_COLORS[i % len(_COLORS)], (len(locs), 1))
        write_ply(os.path.join(out_dir, f"traj_{i:03d}.ply"), locs, col)
        if fuse_shapes and fused_grids[i] is not None:
            # One canonical fused mesh per object (identity pose, fused
            # scale) — the artefact fuse_obj_shape exists to produce.
            path = os.path.join(out_dir, f"fused_shape_{i:03d}.obj")
            if voxel_to_mesh_obj(path, fused_grids[i], np.eye(3),
                                 np.zeros(3), fused_scales[i]) == 0:
                voxel_to_obj(path, fused_grids[i], np.eye(3), np.zeros(3),
                             fused_scales[i])
        if with_shapes:
            for d in traj:
                if "voxel" not in d or "euler" not in d:
                    continue
                rot = _rotmat(d["euler"])
                grid = (fused_grids[i]
                        if fuse_shapes and fused_grids[i] is not None
                        else np.asarray(d["voxel"]) >= 0.5)
                scale = (fused_scales[i] if fuse_shapes
                         else float(d.get("scale", 1.0)))
                path = os.path.join(
                    out_dir, f"shape_{i:03d}_t{d['scan_idx']:03d}.obj")
                if voxel_to_mesh_obj(path, grid, rot, np.asarray(d["loc"]),
                                     scale) == 0:
                    voxel_to_obj(path, grid, rot, np.asarray(d["loc"]),
                                 scale)
