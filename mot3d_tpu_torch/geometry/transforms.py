"""Rotation / rigid-transform helpers
(counterpart of `mot3d_tpu/geometry/transforms.py`).

Replacements for the reference's `mathutils` Euler conversions
(`Tracking/datasets/graph_dataset.py:378-390`), `cam2world`
(`PoseEst/pose_estimation.py:59-70`) and box-corner canonicalisation
(`PoseEst/pose_estimation.py:72-93`).  Every function takes leading batch
dimensions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mot3d_tpu_torch.ops.precision import strict_fp32


def _rotation_stack(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


@strict_fp32()
def euler_to_rotmat(euler: torch.Tensor) -> torch.Tensor:
    """Blender-convention XYZ Euler angles (radians) (..., 3) -> (..., 3, 3).

    Matches `mathutils.Euler((x, y, z)).to_matrix()`: R = Rz @ Ry @ Rx.
    """
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rx = _rotation_stack([[one, zero, zero],
                          [zero, torch.cos(x), -torch.sin(x)],
                          [zero, torch.sin(x), torch.cos(x)]])
    ry = _rotation_stack([[torch.cos(y), zero, torch.sin(y)],
                          [zero, one, zero],
                          [-torch.sin(y), zero, torch.cos(y)]])
    rz = _rotation_stack([[torch.cos(z), -torch.sin(z), zero],
                          [torch.sin(z), torch.cos(z), zero],
                          [zero, zero, one]])
    return rz @ ry @ rx


def _grad_safe_arctan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """arctan2 whose backward survives (0, 0): the origin's value is
    arbitrary, so its inputs are sanitised and its gradient is 0."""
    origin = (y == 0.0) & (x == 0.0)
    return torch.atan2(torch.where(origin, torch.zeros_like(y), y),
                       torch.where(origin, torch.ones_like(x), x))


def rotmat_to_euler(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> XYZ Euler (radians), inverse of
    `euler_to_rotmat`.  Gimbal-safe by clipping; at the poles
    (|sin y| >= 1 - 1e-7) y is pinned to sign(sy) * pi/2 with zero gradient
    and the degenerate branch folds everything into x."""
    sy = torch.clamp(-rot[..., 2, 0], -1.0, 1.0)
    at_pole = torch.abs(sy) >= 1.0 - 1e-7
    y = torch.where(at_pole, torch.sign(sy) * (math.pi / 2),
                    torch.asin(torch.where(at_pole, torch.zeros_like(sy),
                                           sy)))
    cy = torch.sqrt(torch.clamp(1.0 - sy * sy, min=1e-12))
    x = _grad_safe_arctan2(rot[..., 2, 1], rot[..., 2, 2])
    z = _grad_safe_arctan2(rot[..., 1, 0], rot[..., 0, 0])
    x_deg = _grad_safe_arctan2(-rot[..., 1, 2], rot[..., 1, 1])
    degenerate = cy < 1e-6
    x = torch.where(degenerate, x_deg, x)
    z = torch.where(degenerate, torch.zeros_like(z), z)
    return torch.stack([x, y, z], dim=-1)


def quaternion_from_euler(euler: torch.Tensor) -> torch.Tensor:
    """XYZ Euler (..., 3) -> quaternion [x, y, z, w] (..., 4); same formula
    as `Tracking/utils/train_utils.py:47-65`."""
    roll, pitch, yaw = euler[..., 0], euler[..., 1], euler[..., 2]
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    qw = cr * cp * cy + sr * sp * sy
    return torch.stack([qx, qy, qz, qw], dim=-1)


@strict_fp32()
def cam_to_world(points: torch.Tensor, campose: torch.Tensor) -> torch.Tensor:
    """Camera-space points (..., N, 3) -> world via the (..., 4, 4) campose
    (reference `PoseEst/pose_estimation.py:59-70`)."""
    return (points @ campose[..., :3, :3].transpose(-1, -2)
            + campose[..., None, :3, 3])


# Canonical 8-corner ordering produced by the reference's sort_bbox
# (`PoseEst/pose_estimation.py:72-93`), expressed as (sx, sy, sz) signs:
#   0:(+,+,+) 1:(+,+,-) 2:(-,+,-) 3:(-,+,+)   (top face, y = max)
#   4:(+,-,+) 5:(+,-,-) 6:(-,-,-) 7:(-,-,+)   (bottom face, y = min)
_CANONICAL_SIGNS = np.array(
    [
        [1, 1, 1], [1, 1, -1], [-1, 1, -1], [-1, 1, 1],
        [1, -1, 1], [1, -1, -1], [-1, -1, -1], [-1, -1, 1],
    ],
    dtype=np.float32,
)


def canonical_signs(like: torch.Tensor) -> torch.Tensor:
    """`_CANONICAL_SIGNS` as a tensor on `like`'s device and dtype."""
    return torch.as_tensor(_CANONICAL_SIGNS, dtype=like.dtype,
                           device=like.device)


def aabb_corners(mins: torch.Tensor, maxs: torch.Tensor) -> torch.Tensor:
    """Axis-aligned box (..., 3) min and max -> (..., 8, 3) corners in the
    reference's canonical order."""
    center = (mins + maxs) / 2
    half = (maxs - mins) / 2
    return center[..., None, :] + canonical_signs(mins) * half[..., None, :]


def _take(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(c, -2, idx[..., None].expand(idx.shape + (3,)))


def _argsort_desc(v: torch.Tensor) -> torch.Tensor:
    """Flip of a stable ascending argsort (`jnp.flip(jnp.argsort(v))`)."""
    return torch.flip(torch.argsort(v, dim=-1, stable=True), dims=(-1,))


def sort_bbox(corners: torch.Tensor) -> torch.Tensor:
    """Sort arbitrary box corners (..., 8, 3) into the reference canonical
    order: y descending; within the two y-groups x descending; then z with
    the per-pair flip pattern (`PoseEst/pose_estimation.py:72-93`)."""
    c = _take(corners, _argsort_desc(corners[..., 1]))
    c = _take(c, torch.cat([_argsort_desc(c[..., 0:4, 0]),
                            _argsort_desc(c[..., 4:8, 0]) + 4], -1))
    asc = lambda v: torch.argsort(v, dim=-1, stable=True)  # noqa: E731
    return _take(c, torch.cat([_argsort_desc(c[..., 0:2, 2]),
                               asc(c[..., 2:4, 2]) + 2,
                               _argsort_desc(c[..., 4:6, 2]) + 4,
                               asc(c[..., 6:8, 2]) + 6], -1))
