"""Pose-quality metrics, NOCS-paper regime (counterpart of
`mot3d_tpu/geometry/metrics.py`).

Reference `Detection/inference/inference_metrics.py`:
  - rotation error = geodesic angle between normalised rotations, minimised
    over a 180-degree flip about Y (symmetric furniture), in degrees
    (:23-46);
  - location error = L2 in metres (:48-57).
"""

from __future__ import annotations

import math

import torch

from mot3d_tpu_torch.ops.precision import strict_fp32


def _angle(r: torch.Tensor) -> torch.Tensor:
    tr = r.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


@strict_fp32()
def rotation_error_deg(pred_rot: torch.Tensor,
                       gt_rot: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation error (degrees), min over the 180-degree Y flip.

    pred_rot, gt_rot: (..., 3, 3).  Both are scale-normalised by cbrt(det)
    first (the reference's predicted rotation carries the isotropic
    scale)."""
    def normalise(r):
        det = torch.linalg.det(r)
        det = torch.where(det.abs() < 1e-20, torch.ones_like(det), det)
        return r / (torch.sign(det) * det.abs() ** (1.0 / 3.0))[..., None,
                                                                  None]

    r1 = normalise(pred_rot)
    r2 = normalise(gt_rot)
    flip = torch.diag(torch.tensor([-1.0, 1.0, -1.0], dtype=r1.dtype,
                                   device=r1.device))
    r2t = r2.transpose(-1, -2)
    theta = torch.minimum(_angle(r1 @ r2t), _angle(r1 @ flip @ r2t))
    return theta * (180.0 / math.pi)


def location_error(pred_loc: torch.Tensor,
                   gt_loc: torch.Tensor) -> torch.Tensor:
    """L2 distance (..., 3) -> (...)."""
    return torch.linalg.norm(pred_loc - gt_loc, dim=-1)
