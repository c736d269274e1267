"""Pinhole backprojection (counterpart of `mot3d_tpu/geometry/backproject.py`).

Reference `backproject` (`PoseEst/pose_estimation.py:16-43`): p = K^-1
[u, v, 1]^T * z, then y and z negated (the Blender camera looks down -Z).
"""

from __future__ import annotations

import torch


def make_intrinsics(fx: float, fy: float, cx: float, cy: float,
                    device=None) -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def backproject_depth(depth: torch.Tensor, intrinsics: torch.Tensor,
                      mask: torch.Tensor | None = None):
    """Depth map (..., H, W) -> camera-space point map (..., H, W, 3) and
    validity (depth > 0, and `mask` where given)."""
    h, w = depth.shape[-2:]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    z = depth
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts = torch.stack([x, -y, -z], dim=-1)
    valid = depth > 0
    if mask is not None:
        valid = valid & mask.bool()
    return pts, valid
