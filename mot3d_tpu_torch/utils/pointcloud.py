"""Point-cloud helpers (host NumPy): voxel->PC, RGB backprojection, boxes
(counterpart of `mot3d_tpu/utils/pointcloud.py`).

Mirrors `Detection/inference/inference_utils.py:20-279` (get_scale,
construct_box, project_segmask, convert_voxel_to_pc, rgb pc) and
`Tracking/utils/train_utils.py:197-213` (convert_voxel_to_pc) without the
open3d dependency.
"""

from __future__ import annotations

import numpy as np


def get_scale(rotation: np.ndarray) -> np.ndarray:
    """Column norms of a (possibly scaled) rotation matrix
    (`inference_utils.py` get_scale)."""
    return np.linalg.norm(np.asarray(rotation), axis=0)


def convert_voxel_to_pc(voxel_grid: np.ndarray, rot: np.ndarray,
                        trans: np.ndarray, scale: float) -> np.ndarray:
    """Occupied voxel centres -> posed world point cloud
    (`Tracking/utils/train_utils.py:197-213`)."""
    grid = np.asarray(voxel_grid)
    pts = np.stack(np.nonzero(grid), axis=1).astype(np.float64)
    pts = pts / grid.shape[0] - 0.5
    world = (np.eye(3) * scale) @ np.asarray(rot) @ pts.T \
        + np.asarray(trans)[:, None]
    return world.T


def construct_box_minmax(points: np.ndarray) -> np.ndarray:
    """AABB [xmin ymin zmin xmax ymax zmax] of a point cloud
    (`inference_utils.py` construct_box, without open3d)."""
    p = np.asarray(points)
    return np.concatenate([p.min(0), p.max(0)])


def backproject_rgb(rgb: np.ndarray, depth: np.ndarray,
                    intrinsics: np.ndarray) -> np.ndarray:
    """Depth+RGB -> (N, 6) camera-space xyzrgb
    (`Detection/utils/train_utils.py:356-385`)."""
    inv = np.linalg.inv(intrinsics)
    ys, xs = np.nonzero(depth > 0)
    uv = np.stack([xs, ys, np.ones_like(xs)]).astype(np.float64)
    xyz = (inv @ uv).T
    z = depth[ys, xs]
    pts = xyz * z[:, None] / xyz[:, 2:3]
    pts[:, 1] *= -1
    pts[:, 2] *= -1
    return np.concatenate([pts, rgb[ys, xs]], axis=1)


def rgb_image_to_world_pc(rgb: np.ndarray, depth: np.ndarray,
                          campose: np.ndarray,
                          intrinsics: np.ndarray) -> np.ndarray:
    """RGB-D frame -> (N, 6) world xyzrgb (`train_utils.py:387-402`,
    rgb2pc)."""
    pc = backproject_rgb(rgb, depth, intrinsics)
    world = pc[:, :3] @ campose[:3, :3].T + campose[:3, 3]
    return np.concatenate([world, pc[:, 3:]], axis=1)


def project_segmask_world(mask: np.ndarray, depth: np.ndarray,
                          campose: np.ndarray,
                          intrinsics: np.ndarray) -> np.ndarray:
    """Instance mask -> world point cloud (`inference_utils.py`
    project_segmask)."""
    inv = np.linalg.inv(intrinsics)
    ys, xs = np.nonzero(np.logical_and(mask, depth > 0))
    uv = np.stack([xs, ys, np.ones_like(xs)]).astype(np.float64)
    xyz = (inv @ uv).T
    z = depth[ys, xs]
    pts = xyz * z[:, None] / xyz[:, 2:3]
    pts[:, 1] *= -1
    pts[:, 2] *= -1
    return pts @ campose[:3, :3].T + campose[:3, 3]
