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
    validity (depth > 0, and `mask` where given).  The pixel grid takes
    the depth's dtype: a float32 grid minus a 0-dim float64 intrinsic would
    stay float32 under torch's promotion (JAX promotes)."""
    h, w = depth.shape[-2:]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    z = depth
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts = torch.stack([x, -y, -z], dim=-1)
    valid = depth > 0
    if mask is not None:
        valid = valid & mask.bool()
    return pts, valid


def masked_slots(valid: torch.Tensor, max_points: int):
    """Source indices of `gather_masked_values`' slots, batched: valid
    (..., N) -> (indices (..., max_points) into N, slot validity).

    Raster order; when more than `max_points` are valid, valid element r
    (its rank among the valid ones) falls into slot r * max_points //
    n_valid and each slot keeps its first element, an even stride through
    the valid set.  The slot of a kept element is then its rank among the
    kept ones, so the j-th kept element is found by a binary search of
    their running count.  Invalid slots point at the last element."""
    n = valid.shape[-1]
    n_valid = valid.sum(-1, keepdim=True)
    rank = torch.cumsum(valid, -1) - 1
    slot = torch.where(n_valid <= max_points, rank,
                       (rank * max_points) // torch.clamp(n_valid, min=1))
    prev = torch.cat([torch.full_like(slot[..., :1], -1), slot[..., :-1]],
                     -1)
    first = valid & ((slot != prev) | (rank == 0))
    kept = torch.cumsum(first, -1)
    want = torch.arange(1, max_points + 1, device=valid.device).expand(
        valid.shape[:-1] + (max_points,)).contiguous()
    idx = torch.searchsorted(kept, want)
    ok = idx < n
    return torch.clamp(idx, max=n - 1), ok


def gather_masked_values(values: torch.Tensor, valid: torch.Tensor,
                         max_points: int):
    """Compact masked values into a fixed-size buffer.

    values: any shape with a trailing feature dim D (e.g. (H, W, D)); valid:
    the matching leading shape.  Returns ((max_points, D) values with the
    invalid slots zeroed, (max_points,) validity, (max_points,) source flat
    indices), deterministic and in raster order, with an even stride
    through the valid set when more than `max_points` are valid
    (`masked_slots`)."""
    d = values.shape[-1]
    flat_vals = values.reshape(-1, d)
    idx, ok = masked_slots(valid.reshape(-1), max_points)
    out = torch.where(ok[:, None], flat_vals[idx],
                      torch.zeros((), dtype=values.dtype,
                                  device=values.device))
    return out, ok, idx


def gather_masked_points(points: torch.Tensor, valid: torch.Tensor,
                         max_points: int):
    """`gather_masked_values` for 3-D points: returns (points, valid)."""
    pts, ok, _ = gather_masked_values(points, valid, max_points)
    return pts, ok
