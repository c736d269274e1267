"""Region proposal network, inference half (counterpart of
`mot3d_tpu/models/rpn.py`): anchors, box coding, head and padded proposal
selection.  Proposal counts are padded to config maxima with validity
masks; every function takes a leading batch of images.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
