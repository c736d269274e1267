"""F2F (frame-to-frame Mask R-CNN) baseline (counterpart of
`mot3d_tpu/tracking/f2f.py`).

The paper's non-learned comparison baseline, shipped by the reference as:

  - `postprocess_dets_office_F2F` (`Detection/tracker/postprocess.py:
    354-411`): per detection above the objectness threshold, zero the depth
    map outside the predicted box and backproject the predicted binary mask
    into a segment point cloud (`project_segmask_F2F`,
    `Detection/inference/inference_utils.py:67-83`): no NOCS, no pose fit;
  - trajectory assembly by greedy centre matching
    (`Tracking/tracker/tracking_front.py:24-62` pred_trajectory);
  - `calculate_F2F_metrics` (`Detection/inference/inference_utils.py:
    224-252`): MOTA = 1 - (misses + FPs + switches) / gt_objects, plus
    F1, precision and recall.

`segment_centers` runs every detection of a frame at once (one
backprojection broadcast over the detection axis and a masked mean);
assembly and metrics are host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from mot3d_tpu_torch.geometry.backproject import backproject_depth
from mot3d_tpu_torch.ops.precision import strict_fp32
from mot3d_tpu_torch.tracking.heuristic import HeuristicTracker
from mot3d_tpu_torch.tracking.mot_metrics import (MOTAccumulator,
                                                  norm2squared_matrix)


@strict_fp32()
def segment_centers(masks: torch.Tensor, boxes: torch.Tensor,
                    valid: torch.Tensor, depth: torch.Tensor,
                    intrinsics: torch.Tensor,
                    campose: Optional[torch.Tensor] = None):
    """Per-detection segment point-cloud centres.

    masks (D, H, W) in [0, 1]; boxes (D, 4) XYXY; valid (D,); depth (H, W).
    Each detection keeps the pixels inside its box (the reference's
    zero-pad, `inference_utils.py:74-78`) where its mask is >= 0.5 and the
    depth is positive; the centre is the mean of their backprojected
    points (camera space, or world space when a campose (4, 4) is given).
    Returns (centres (D, 3), has_points (D,))."""
    h, w = depth.shape[-2:]
    vv = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[:, None]
    uu = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, :]
    b = boxes[:, None, None, :]
    in_box = ((uu >= b[..., 0]) & (uu < b[..., 2])
              & (vv >= b[..., 1]) & (vv < b[..., 3]))
    m = (masks >= 0.5) & in_box & valid[:, None, None]
    pts, pvalid = backproject_depth(depth, intrinsics, m)  # (H, W, 3), (D, H, W)
    if campose is not None:
        pts = pts @ campose[:3, :3].T + campose[:3, 3]
    wsum = pvalid.sum((1, 2))
    total = torch.where(pvalid[..., None], pts,
                        torch.zeros_like(pts)).sum((1, 2))
    has = wsum > 0
    centre = torch.where(has[:, None],
                         total / torch.clamp(wsum, min=1)[:, None].to(
                             total.dtype),
                         torch.zeros_like(total))
    return centre, has


class F2FTracker:
    """Greedy frame-to-frame centre matching (pred_trajectory semantics,
    `tracking_front.py:24-62`), reusing the heuristic matcher."""

    def __init__(self, dist_thres: float = 0.25, seq_len: int = 25):
        self._heur = HeuristicTracker(dist_thres=dist_thres, seq_len=seq_len)

    def track(self, per_frame_dets: List[List[dict]]) -> List[List[dict]]:
        """per_frame_dets[t] = [{"loc": centre, "cls": c, ...}, ...]."""
        return self._heur.track(per_frame_dets)


def eval_f2f(pred_trajectories: List[List[dict]],
             gt_trajectories: List[List[dict]], seq_len: int,
             dist_gate: float = 0.4) -> Dict[str, float]:
    """The F2F metric block (`calculate_F2F_metrics`): MOTA from the
    accumulator (misses + FPs + switches over GT objects) plus F1,
    precision and recall from the same counts."""
    acc = MOTAccumulator()
    for t in range(seq_len):
        gt_ids, gt_pos = [], []
        for ti, traj in enumerate(gt_trajectories):
            for d in traj:
                if d["scan_idx"] == t:
                    gt_ids.append(d.get("obj_idx", ti))
                    gt_pos.append(np.asarray(d["loc"], np.float64))
        hyp_ids, hyp_pos = [], []
        for ti, traj in enumerate(pred_trajectories):
            for d in traj:
                if d["scan_idx"] == t:
                    hyp_ids.append(d.get("obj_idx", ti))
                    hyp_pos.append(np.asarray(d["loc"], np.float64))
        dists = norm2squared_matrix(
            np.asarray(gt_pos, np.float64).reshape(len(gt_ids), 3),
            np.asarray(hyp_pos, np.float64).reshape(len(hyp_ids), 3),
            max_d2=dist_gate)
        acc.update(gt_ids, hyp_ids, dists)
    s = acc.summary()
    p, r = s.get("precision", 0.0), s.get("recall", 0.0)
    s["f1"] = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return s
