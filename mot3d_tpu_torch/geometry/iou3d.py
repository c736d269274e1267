"""Box IoU ops: BEV-polygon 3D IoU, 2D IoU and voxel IoU
(counterpart of `mot3d_tpu/geometry/iou3d.py`).

Replacement for the reference's qhull + Sutherland–Hodgman stack
(`Tracking/utils/train_utils.py:83-176`): the intersection of two convex
quads is clipped in a fixed 16-vertex buffer and measured with the shoelace
formula.  All functions take leading batch dimensions, so a whole (T, I, G)
block of box pairs is one pass.

Box corner convention: the canonical 8-corner order of
`geometry.transforms.aabb_corners` / `sort_bbox`; BEV rect = corners
[3, 2, 1, 0] of (x, z), counter-clockwise.
"""

from __future__ import annotations

import torch

_BUF = 16


def _clip_by_edge(pts: torch.Tensor, count: torch.Tensor,
                  cp1: torch.Tensor, cp2: torch.Tensor):
    """One Sutherland–Hodgman stage: clip the polygon (pts (..., n, 2),
    count (...)) by the half-plane left of cp1 -> cp2 (strict inside test,
    as the reference `polygon_clip`)."""
    n = pts.shape[-2]
    idx = torch.arange(n, device=pts.device)
    in_poly = idx < count[..., None]
    prev_idx = torch.where(idx == 0,
                           torch.clamp(count - 1, min=0)[..., None],
                           idx - 1)
    s = torch.gather(pts, -2, prev_idx[..., None].expand(pts.shape))
    e = pts
    d = cp2 - cp1

    def inside(p):
        return (d[..., None, 0] * (p[..., 1] - cp1[..., None, 1])
                > d[..., None, 1] * (p[..., 0] - cp1[..., None, 0]))

    ins_e = inside(e) & in_poly
    ins_s = inside(s) & in_poly

    dp = s - e
    n1 = cp1[..., 0] * cp2[..., 1] - cp1[..., 1] * cp2[..., 0]
    n2 = s[..., 0] * e[..., 1] - s[..., 1] * e[..., 0]
    den = ((-d[..., None, 0]) * dp[..., 1]
           - (-d[..., None, 1]) * dp[..., 0])
    safe_den = torch.where(torch.abs(den) < 1e-12, torch.ones_like(den), den)
    ix = (n1[..., None] * dp[..., 0] - n2 * (-d[..., None, 0])) / safe_den
    iy = (n1[..., None] * dp[..., 1] - n2 * (-d[..., None, 1])) / safe_den
    ipt = torch.stack([ix, iy], dim=-1)

    emit_i = in_poly & (ins_e != ins_s)
    emit_e = ins_e
    batch = pts.shape[:-2]
    cand = torch.stack([ipt, e], dim=-2).reshape(batch + (2 * n, 2))
    flags = torch.stack([emit_i, emit_e], dim=-1).reshape(batch + (2 * n,))

    pos = torch.cumsum(flags.long(), -1) - 1
    tgt = torch.where(flags, torch.clamp(pos, max=n - 1),
                      torch.full_like(pos, n))
    out = pts.new_zeros(batch + (n + 1, 2)).scatter(
        -2, tgt[..., None].expand(cand.shape), cand)[..., :n, :]
    new_count = torch.clamp(flags.sum(-1), max=n)
    return out, new_count


def _shoelace(pts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    n = pts.shape[-2]
    idx = torch.arange(n, device=pts.device)
    m = idx < count[..., None]
    nxt = torch.where(idx + 1 >= count[..., None], torch.zeros_like(idx),
                      idx + 1)
    x, y = pts[..., 0], pts[..., 1]
    terms = x * torch.gather(y, -1, nxt) - torch.gather(x, -1, nxt) * y
    return 0.5 * torch.abs(torch.where(m, terms,
                                       torch.zeros_like(terms)).sum(-1))


def polygon_clip_area(subject: torch.Tensor, clip: torch.Tensor):
    """Area of the intersection of two convex CCW quads (..., 4, 2).
    Returns (area, count); count == 0 is the reference's empty case."""
    subject, clip = torch.broadcast_tensors(subject, clip)
    batch = subject.shape[:-2]
    pts = subject.new_zeros(batch + (_BUF, 2))
    pts[..., :4, :] = subject
    count = torch.full(batch, 4, dtype=torch.long, device=subject.device)
    for k in range(4):
        pts, count = _clip_by_edge(pts, count, clip[..., (k - 1) % 4, :],
                                   clip[..., k, :])
    return _shoelace(pts, count), count


def _bev_rect(corners: torch.Tensor) -> torch.Tensor:
    return corners[..., [3, 2, 1, 0], :][..., [0, 2]]


def _quad_area(rect: torch.Tensor) -> torch.Tensor:
    count = torch.full(rect.shape[:-2], 4, dtype=torch.long,
                       device=rect.device)
    return _shoelace(rect, count)


def _box_vol(c: torch.Tensor) -> torch.Tensor:
    a = torch.linalg.norm(c[..., 0, :] - c[..., 1, :], dim=-1)
    b = torch.linalg.norm(c[..., 1, :] - c[..., 2, :], dim=-1)
    h = torch.linalg.norm(c[..., 0, :] - c[..., 4, :], dim=-1)
    return a * b * h


def box3d_iou(corners1: torch.Tensor, corners2: torch.Tensor):
    """(3D IoU, BEV IoU) of canonical (..., 8, 3) corner boxes
    (reference `compute_3d_iou`, `Tracking/utils/train_utils.py:83-103`)."""
    r1, r2 = _bev_rect(corners1), _bev_rect(corners2)
    a1, a2 = _quad_area(r1), _quad_area(r2)
    inter_area, _ = polygon_clip_area(r1, r2)
    iou2d = inter_area / torch.clamp(a1 + a2 - inter_area, min=1e-12)
    ymax = torch.minimum(corners1[..., 0, 1], corners2[..., 0, 1])
    ymin = torch.maximum(corners1[..., 4, 1], corners2[..., 4, 1])
    inter_vol = inter_area * torch.clamp(ymax - ymin, min=0.0)
    v1, v2 = _box_vol(corners1), _box_vol(corners2)
    iou = inter_vol / torch.clamp(v1 + v2 - inter_vol, min=1e-12)
    return iou, iou2d


def box3d_iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> torch.Tensor:
    """Pairwise 3D IoU: (..., M, 8, 3) x (..., N, 8, 3) -> (..., M, N)."""
    return box3d_iou(boxes1[..., :, None, :, :], boxes2[..., None, :, :, :])[0]


def box2d_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """IoU of XYXY boxes (..., 4) (detectron2 pairwise_iou math)."""
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    a1 = (torch.clamp(b1[..., 2] - b1[..., 0], min=0)
          * torch.clamp(b1[..., 3] - b1[..., 1], min=0))
    a2 = (torch.clamp(b2[..., 2] - b2[..., 0], min=0)
          * torch.clamp(b2[..., 3] - b2[..., 1], min=0))
    return inter / torch.clamp(a1 + a2 - inter, min=1e-12)


def box2d_iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) -> (..., M, N) 2D IoU matrix."""
    return box2d_iou(boxes1[..., :, None, :], boxes2[..., None, :, :])


def voxel_iou(pred: torch.Tensor, gt: torch.Tensor, thresh: float = 0.5
              ) -> torch.Tensor:
    """Occupancy IoU of (..., D, H, W) grids at a probability threshold
    (reference `compute_voxel_iou`); gt is binarised at 0.5."""
    p = pred >= thresh
    g = gt >= 0.5
    dims = (-3, -2, -1)
    inter = (p & g).sum(dims).to(pred.dtype)
    union = (p | g).sum(dims).to(pred.dtype)
    return inter / torch.clamp(union, min=1.0)
