"""Region proposal network (counterpart of `mot3d_tpu/models/rpn.py`):
anchors, box coding, head, padded proposal selection and the training
losses.  Proposal counts are padded to config maxima with validity masks;
every function takes a leading batch of images.

`select_proposals` is batch-native (the JAX package's
`select_proposals_batched`); training calls it at the train top-k.
Randomness: the anchor subsampling of `rpn_losses` (and the ROI sampling of
`models/mask_rcnn.py:sample_rois`) takes its uniform draws as an input, one
per anchor, where the JAX package draws them from a key with
`jax.random.uniform`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.geometry.iou3d import box2d_iou_matrix
from mot3d_tpu_torch.ops.nms import gather_rows, nms_mask, top_k_by_score

_CLAMP = float(np.log(1000.0 / 16))


@functools.lru_cache(maxsize=4)
def generate_anchors(pad_h: int, pad_w: int, sizes: tuple, ratios: tuple,
                     strides: tuple = (4, 8, 16, 32, 64),
                     offset: float = 0.5) -> np.ndarray:
    """All anchors over the padded image, XYXY, finest level first; one
    size per level, all ratios per location, centres at
    (i + offset) * stride."""
    all_anchors = []
    for size, stride in zip(sizes, strides):
        h, w = pad_h // stride, pad_w // stride
        ws = np.array([size / np.sqrt(r) for r in ratios])
        hs = np.array([size * np.sqrt(r) for r in ratios])
        cx = (np.arange(w) + offset) * stride
        cy = (np.arange(h) + offset) * stride
        cxg, cyg = np.meshgrid(cx, cy)
        boxes = np.stack([
            cxg[:, :, None] - ws / 2, cyg[:, :, None] - hs / 2,
            cxg[:, :, None] + ws / 2, cyg[:, :, None] + hs / 2,
        ], axis=-1)
        all_anchors.append(boxes.reshape(-1, 4))
    return np.concatenate(all_anchors).astype(np.float32)


def level_slices(pad_h: int, pad_w: int, num_ratios: int,
                 strides=(4, 8, 16, 32, 64)):
    counts = [(pad_h // s) * (pad_w // s) * num_ratios for s in strides]
    offs = np.concatenate([[0], np.cumsum(counts)])
    return [(int(offs[i]), int(offs[i + 1])) for i in range(len(strides))]


def encode_deltas(anchors: torch.Tensor, boxes: torch.Tensor
                  ) -> torch.Tensor:
    """Box -> (dx, dy, dw, dh) relative to anchors (Faster R-CNN coding)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    bx = boxes[..., 0] + bw / 2
    by = boxes[..., 1] + bh / 2
    aw_c = torch.clamp(aw, min=1e-6)
    ah_c = torch.clamp(ah, min=1e-6)
    return torch.stack([
        (bx - ax) / aw_c,
        (by - ay) / ah_c,
        torch.log(torch.clamp(bw, min=1e-6) / aw_c),
        torch.log(torch.clamp(bh, min=1e-6) / ah_c),
    ], dim=-1)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor
                  ) -> torch.Tensor:
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    dx, dy = deltas[..., 0], deltas[..., 1]
    dw = torch.clamp(deltas[..., 2], -_CLAMP, _CLAMP)
    dh = torch.clamp(deltas[..., 3], -_CLAMP, _CLAMP)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def clip_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return torch.stack([
        torch.clamp(boxes[..., 0], 0, width),
        torch.clamp(boxes[..., 1], 0, height),
        torch.clamp(boxes[..., 2], 0, width),
        torch.clamp(boxes[..., 3], 0, height),
    ], dim=-1)


def smooth_l1(x: torch.Tensor, beta: float = 0.0) -> torch.Tensor:
    ax = torch.abs(x)
    if beta <= 0:
        return ax
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) exactly, as `jax.nn.softplus`: `F.softplus` returns x
    itself above its threshold of 20."""
    return torch.logaddexp(x, x.new_zeros(()))


class RPNHead(nn.Module):
    """Shared 3x3 conv + objectness and delta 1x1 convs over every level;
    outputs flattened in (h, w, anchor) order like the NHWC flax head."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness = nn.Conv2d(channels, num_anchors, 1)
        self.deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        objs, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            b = f.shape[0]
            objs.append(self.objectness(t).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.deltas(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return torch.cat(objs, 1), torch.cat(deltas, 1)


def select_proposals(anchors: torch.Tensor, objectness: torch.Tensor,
                     deltas: torch.Tensor, slices, image_hw,
                     pre_nms_topk: int, post_nms_topk: int,
                     nms_thresh: float, exact_nms: bool = True):
    """Per-image proposal selection for a batch: per-level top-k -> decode
    -> clip -> level-aware NMS -> global top-k.

    anchors (A, 4); objectness (B, A); deltas (B, A, 4).  Returns (boxes
    (B, P, 4), scores (B, P), valid (B, P))."""
    cand_boxes, cand_scores, cand_keep = [], [], []
    for s0, s1 in slices:
        n_l = s1 - s0
        k = min(pre_nms_topk, n_l)
        scores_l = objectness[:, s0:s1]
        idx, ok = top_k_by_score(
            scores_l, torch.ones_like(scores_l, dtype=torch.bool), k)
        boxes_l = clip_boxes(decode_deltas(anchors[s0:s1][idx],
                                           gather_rows(deltas[:, s0:s1], idx)),
                             *image_hw)
        wh_ok = ((boxes_l[..., 2] > boxes_l[..., 0] + 1e-3)
                 & (boxes_l[..., 3] > boxes_l[..., 1] + 1e-3))
        valid_l = ok & wh_ok
        scores_lk = gather_rows(scores_l, idx)
        cand_boxes.append(boxes_l)
        cand_scores.append(scores_lk)
        cand_keep.append(nms_mask(boxes_l, scores_lk, valid_l, nms_thresh,
                                  exact_nms))
    boxes = torch.cat(cand_boxes, 1)
    scores = torch.cat(cand_scores, 1)
    keep = torch.cat(cand_keep, 1)
    k = min(post_nms_topk, boxes.shape[1])
    idx, ok = top_k_by_score(torch.where(keep, scores,
                                         torch.full_like(scores, -torch.inf)),
                             keep, k)
    return gather_rows(boxes, idx), gather_rows(scores, idx), ok



# -------------------------------------------------------------- training


class RPNTargets(NamedTuple):
    labels: torch.Tensor         # (..., N_anchors) 1 pos / 0 neg / -1 ignore
    matched_boxes: torch.Tensor  # (..., N_anchors, 4)


def label_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, pos_iou: float, neg_iou: float
                  ) -> RPNTargets:
    """Anchor labelling: pos >= pos_iou or best-per-GT; neg < neg_iou.
    anchors (N, 4); gt_boxes (..., M, 4), gt_valid (..., M)."""
    iou = box2d_iou_matrix(anchors, gt_boxes)                 # (..., N, M)
    iou = torch.where(gt_valid[..., None, :], iou, torch.full_like(iou, -1.0))
    best_gt = torch.argmax(iou, -1)
    best_iou = iou.amax(-1)
    labels = torch.where(best_iou >= pos_iou, 1,
                         torch.where(best_iou < neg_iou, 0, -1))
    # Force the best anchor of each GT positive (ties included).
    per_gt_best = iou.amax(-2, keepdim=True)                  # (..., 1, M)
    is_best = ((iou == per_gt_best) & gt_valid[..., None, :]
               & (per_gt_best > 0)).any(-1)
    labels = torch.where(is_best, 1, labels)
    matched = torch.gather(gt_boxes, -2, best_gt[..., None].expand(
        best_gt.shape + (4,)))
    return RPNTargets(labels, matched)


def _rank_desc(score: torch.Tensor) -> torch.Tensor:
    """Rank of each entry in a stable descending order (the JAX package's
    stable `argsort(-score)`)."""
    order = torch.argsort(-score, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    return ranks.scatter_(-1, order, torch.arange(
        score.shape[-1], device=score.device).expand_as(order))


def subsample_labels(labels: torch.Tensor, rand: torch.Tensor,
                     num_samples: int, positive_fraction: float):
    """Random sampling to fixed counts via randomised top-k.  labels
    (..., N); rand (..., N) uniform draws.  Returns (pos_sel, neg_sel)
    bool masks with at most num_samples entries set in all."""
    minus = torch.full_like(rand, -1.0)
    num_pos = int(num_samples * positive_fraction)
    pos_sel = (labels == 1) & (
        _rank_desc(torch.where(labels == 1, rand, minus)) < num_pos)
    num_neg = num_samples - pos_sel.sum(-1, keepdim=True)
    neg_sel = (labels == 0) & (
        _rank_desc(torch.where(labels == 0, rand, minus)) < num_neg)
    return pos_sel, neg_sel


def rpn_losses(objectness: torch.Tensor, deltas: torch.Tensor,
               anchors: torch.Tensor, targets: RPNTargets,
               rand: torch.Tensor, batch_per_image: int,
               positive_fraction: float):
    """Per-image RPN losses (objectness BCE + box L1), sampled, each
    divided by the number of sampled anchors (detectron2).  objectness
    (..., N), deltas (..., N, 4), rand (..., N).  Returns two (...,)
    tensors."""
    pos_sel, neg_sel = subsample_labels(targets.labels, rand,
                                        batch_per_image, positive_fraction)
    sel = (pos_sel | neg_sel).to(objectness.dtype)
    norm = torch.clamp(sel.sum(-1), min=1.0)

    y = (targets.labels == 1).to(objectness.dtype)
    per_anchor = y * softplus(-objectness) + (1 - y) * softplus(objectness)
    obj_loss = (per_anchor * sel).sum(-1) / norm

    gt_deltas = encode_deltas(anchors, targets.matched_boxes)
    box_l1 = smooth_l1(deltas - gt_deltas).sum(-1)
    box_loss = (box_l1 * pos_sel.to(box_l1.dtype)).sum(-1) / norm
    return obj_loss, box_loss
