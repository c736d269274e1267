"""Padded non-maximum suppression (counterpart of `mot3d_tpu/ops/nms.py`).

Sort-free: rank dominance is the pairwise predicate
``higher(i, j) = s_i > s_j or (s_i == s_j and i < j)`` (the order a stable
descending sort gives), so suppression is elementwise work on the (K, K) IoU
matrix.  Every function takes leading batch dimensions, so all images (and
all classes) of a batch are one pass.

- fast NMS (YOLACT): keep j unless ANY higher-ranked valid box overlaps it
  above the threshold.  Slightly over-suppresses versus exact NMS.
- exact NMS: ``keep[j] = valid[j] and no higher-ranked KEPT box suppresses
  j`` is the unique fixpoint of ``keep <- valid & ~any(keep & S)``; it is
  iterated from ``keep = valid`` until it stops changing (at most K + 1
  steps, in practice the longest suppression chain).  That iteration
  (`nms_mask_plain`) serves CPU tensors; a CUDA tensor goes through the K3
  kernel (`ops/cuda/nms.py:exact_nms_mask`: sort, scan, unsort), which keeps
  the same set.
"""

from __future__ import annotations

import torch

from mot3d_tpu_torch.geometry.iou3d import box2d_iou_matrix
from mot3d_tpu_torch.ops.cuda.nms import exact_nms_mask, fixpoint_keep


def _suppression_matrix(boxes, scores, valid, iou_threshold: float):
    """S[..., i, j]: valid box i ranks above valid box j and overlaps it
    beyond the threshold."""
    k = boxes.shape[-2]
    iou = box2d_iou_matrix(boxes, boxes)
    s = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    idx = torch.arange(k, device=boxes.device)
    higher = ((s[..., :, None] > s[..., None, :])
              | ((s[..., :, None] == s[..., None, :])
                 & (idx[:, None] < idx[None, :])))
    return ((iou > iou_threshold) & higher & valid[..., :, None]
            & valid[..., None, :])


def nms_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, iou_threshold: float,
                   exact: bool = True) -> torch.Tensor:
    """`nms_mask` as plain tensor code on the (K, K) suppression matrix, on
    any device: the plain version the K3 kernel is held against."""
    suppress = _suppression_matrix(boxes, scores, valid, iou_threshold)
    if not exact:
        return valid & ~suppress.any(-2)
    return fixpoint_keep(valid, suppress)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, exact: bool = True) -> torch.Tensor:
    """Keep mask (..., K) for XYXY boxes (..., K, 4); invalid boxes are
    dropped.  exact=True keeps the same set as torchvision/detectron2 NMS
    on the valid subset (the K3 kernel for a tensor that is not on the CPU);
    exact=False is fast NMS."""
    if exact and boxes.device.type != "cpu":
        return exact_nms_mask(boxes, scores, valid, iou_threshold)
    return nms_mask_plain(boxes, scores, valid, iou_threshold, exact)


def classwise_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                       valid: torch.Tensor, iou_threshold: float,
                       exact: bool = True) -> torch.Tensor:
    """Class-aware NMS on a (..., P, C) layout: boxes (..., P, C, 4),
    scores/valid (..., P, C) -> keep (..., P, C).  Boxes of different
    classes never suppress each other; each class is an independent
    (P, P) problem."""
    keep = nms_mask(boxes.movedim(-2, -3), scores.movedim(-1, -2),
                    valid.movedim(-1, -2), iou_threshold, exact)
    return keep.movedim(-2, -1)


def top_k_by_score(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Indices and validity of the top-k valid scores along the last axis.

    Ties keep the lower index first (`jax.lax.top_k`'s order), which
    `torch.topk` does not promise: a stable descending sort does."""
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[..., :k], torch.isfinite(top[..., :k])


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...), idx (B, J) -> (B, J, ...)."""
    tail = x.shape[2:]
    full = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(x, 1, full)
