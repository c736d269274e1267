"""NOCS (normalised object coordinate) ROI heads and their losses
(counterpart of `mot3d_tpu/models/nocs_head.py`).

`NocsDecoder` (regression): (N, 14, 14, C) pooled features -> three
transposed-conv blocks (256, 128, 64 channels, the last one 2x up) -> a
3-channel transposed conv -> sigmoid: (N, 28, 28, 3) in [0, 1].
`NocsBinDecoder` (bin classification): one tower of three transposed
convs per coordinate channel -> (N, 28, 28, 3, bins) logits, turned into
values by `nocs_bins_to_values`.

A block is ConvTranspose -> GroupNorm(32) -> ReLU with norm="gn" and
ConvTranspose -> ReLU -> affine with norm="affine": the reference applies
its BatchNorm after the activation, so the folded affine of an imported
checkpoint sits there too.

Losses (`nocs_loss`, `nocs_bin_loss`): the reference pastes the predicted
patch into an image canvas and takes a symmetry-aware smooth-L1 where the
predicted and GT boxes overlap (`Detection/roi_heads/nocs_head.py:20-129`);
here the overlap is sampled on a fixed grid and both patches are bilinearly
interpolated there, batched over instances.  Symmetric classes take the
smaller loss of the GT and its 180-degree rotation about Y, background
(white) pixels exempt.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.models.heads import conv_transpose
from mot3d_tpu_torch.models.norms import compute_in, make_norm, norm_name


def _norm_act(norm_layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(norm_layer, nn.GroupNorm):
        return F.relu(compute_in(norm_layer, x))
    return compute_in(norm_layer, F.relu(x))


class NocsDecoder(nn.Module):
    def __init__(self, in_channels: int, norm: str = "gn",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        chans = (in_channels, 256, 128, 64, 3)
        kernels = (3, 3, 4, 3)
        strides = (1, 1, 2, 1)
        for i in range(4):
            self.add_module(f"ConvTranspose_{i}", conv_transpose(
                2, chans[i], chans[i + 1], kernels[i], strides[i]))
        self.norms = [norm_name(norm, i) for i in range(3)]
        for i, name in enumerate(self.norms):
            self.add_module(name, make_norm(norm, 32, chans[i + 1]))

    def forward(self, x):
        """(N, 14, 14, C) -> (N, 28, 28, 3), the sigmoid taken in float32
        under a compute dtype."""
        x = x.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i, name in enumerate(self.norms):
            x = _norm_act(getattr(self, name),
                          compute_in(getattr(self, f"ConvTranspose_{i}"), x))
        x = compute_in(self.ConvTranspose_3, x)
        if self.dtype is not None:
            x = x.float()
        return torch.sigmoid(x).permute(0, 2, 3, 1)


class NocsBinDecoder(nn.Module):
    """Towers `l1_c -> l2_c -> l3_c` for c in r, g, b (128, 64 and `num_bins`
    channels, the middle one 2x up); the flax model numbers the towers'
    norm layers 0..5 in that order."""

    def __init__(self, in_channels: int, num_bins: int = 32,
                 norm: str = "gn", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.norms = [norm_name(norm, i) for i in range(6)]
        for t, ch in enumerate("rgb"):
            self.add_module(f"l1_{ch}", conv_transpose(2, in_channels, 128, 3))
            self.add_module(self.norms[2 * t], make_norm(norm, 32, 128))
            self.add_module(f"l2_{ch}", conv_transpose(2, 128, 64, 4, 2))
            self.add_module(self.norms[2 * t + 1], make_norm(norm, 32, 64))
            self.add_module(f"l3_{ch}", conv_transpose(2, 64, num_bins, 3))

    def forward(self, x):
        """(N, 14, 14, C) -> (N, 28, 28, 3, bins) logits (float32 under a
        compute dtype)."""
        x = x.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        outs = []
        for t, ch in enumerate("rgb"):
            y = _norm_act(getattr(self, self.norms[2 * t]),
                          compute_in(getattr(self, f"l1_{ch}"), x))
            y = _norm_act(getattr(self, self.norms[2 * t + 1]),
                          compute_in(getattr(self, f"l2_{ch}"), y))
            y = compute_in(getattr(self, f"l3_{ch}"), y)
            if self.dtype is not None:
                y = y.float()
            outs.append(y.permute(0, 2, 3, 1))
        return torch.stack(outs, dim=-2)


def nocs_bins_to_values(logits: torch.Tensor, num_bins: int = 32
                        ) -> torch.Tensor:
    """(..., 3, bins) logits -> (..., 3) values: argmax bin / (bins - 1);
    ties take the first bin."""
    idx = torch.argmax(logits, dim=-1)
    return idx.to(logits.dtype) / (num_bins - 1)


# ------------------------------------------------------------------ loss

_Y_ROTATIONS = np.stack([
    np.eye(3, dtype=np.float32),
    # 180 degrees about Y (`Detection/utils/train_utils.py:57-60`).
    np.array([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]], np.float32),
])


def _bilinear_patch_sample(patch: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor, box: torch.Tensor
                           ) -> torch.Tensor:
    """Sample patches (N, P, P, C) at image coords u, v (N, ...) given their
    image boxes (N, 4) XYXY, aligned=True convention, clamped at the patch
    edges -> (N, ..., C)."""
    n, p = patch.shape[0], patch.shape[1]
    x0, y0, x1, y1 = (box[:, i].reshape((n,) + (1,) * (u.dim() - 1))
                      for i in range(4))
    fx = (u - x0) / torch.clamp(x1 - x0, min=1e-6) * p - 0.5
    fy = (v - y0) / torch.clamp(y1 - y0, min=1e-6) * p - 0.5
    fx = torch.clamp(fx, 0.0, p - 1.0)
    fy = torch.clamp(fy, 0.0, p - 1.0)
    fx0, fy0 = torch.floor(fx), torch.floor(fy)
    ix0, iy0 = fx0.long(), fy0.long()
    ix1 = torch.clamp(ix0 + 1, max=p - 1)
    iy1 = torch.clamp(iy0 + 1, max=p - 1)
    wx1 = fx - fx0
    wy1 = fy - fy0
    flat = patch.reshape(n, p * p, -1)
    c = flat.shape[-1]

    def at(iy, ix):
        idx = (iy * p + ix).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(u.shape + (c,))

    return (at(iy0, ix0) * ((1 - wy1) * (1 - wx1))[..., None]
            + at(iy0, ix1) * ((1 - wy1) * wx1)[..., None]
            + at(iy1, ix0) * (wy1 * (1 - wx1))[..., None]
            + at(iy1, ix1) * (wy1 * wx1)[..., None])


def _smooth_l1(x: torch.Tensor, beta: float = 0.1) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _rotate_nocs(values: torch.Tensor, rot) -> torch.Tensor:
    """Rotate NOCS coordinates about the grid centre; background (white)
    pixels, whose centred sum is 1.5, are exempt."""
    rot = torch.as_tensor(rot, dtype=values.dtype, device=values.device)
    centred = values - 0.5
    rotated = centred @ rot.T + 0.5
    is_bg = torch.abs(centred.sum(-1) - 1.5) < 0.05
    return torch.where(is_bg[..., None], values, rotated)


def _overlap_grid(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                  grid: int):
    """Sample points (N, grid, grid) u, v on each pred/GT box overlap and
    whether the overlap is larger than a pixel each way."""
    x0 = torch.maximum(pred_boxes[:, 0], gt_boxes[:, 0])
    y0 = torch.maximum(pred_boxes[:, 1], gt_boxes[:, 1])
    x1 = torch.minimum(pred_boxes[:, 2], gt_boxes[:, 2])
    y1 = torch.minimum(pred_boxes[:, 3], gt_boxes[:, 3])
    valid = (x1 > x0 + 1.0) & (y1 > y0 + 1.0)
    t = (torch.arange(grid, dtype=pred_boxes.dtype,
                      device=pred_boxes.device) + 0.5) / grid
    us = x0[:, None] + t * (x1 - x0)[:, None]               # (N, grid)
    vs = y0[:, None] + t * (y1 - y0)[:, None]
    uu = us[:, None, :].expand(-1, grid, -1)
    vv = vs[:, :, None].expand(-1, -1, grid)
    return uu, vv, valid


def nocs_sample_loss(pred_patch: torch.Tensor, gt_patch: torch.Tensor,
                     pred_box: torch.Tensor, gt_box: torch.Tensor,
                     is_symmetric: torch.Tensor, grid: int = 28):
    """Per-instance symmetry smooth-L1 on the pred/GT box overlap, batched:
    pred_patch (N, 28, 28, 3), gt_patch (N, P, P, 3), boxes (N, 4) XYXY,
    is_symmetric (N,).  Returns (loss (N,), valid (N,))."""
    uu, vv, valid = _overlap_grid(pred_box, gt_box, grid)
    pred_vals = _bilinear_patch_sample(pred_patch, uu, vv, pred_box)
    gt_vals = _bilinear_patch_sample(gt_patch, uu, vv, gt_box)
    loss_id = _smooth_l1(pred_vals - gt_vals).mean((1, 2, 3))
    gt_rot = _rotate_nocs(gt_vals, _Y_ROTATIONS[1])
    loss_rot = _smooth_l1(pred_vals - gt_rot).mean((1, 2, 3))
    loss = torch.where(is_symmetric, torch.minimum(loss_id, loss_rot),
                       loss_id)
    return torch.where(valid, loss, torch.zeros_like(loss)), valid


def _symmetric(gt_classes, symmetric_class_ids):
    ids = torch.as_tensor(symmetric_class_ids, device=gt_classes.device)
    return torch.isin(gt_classes, ids.to(gt_classes.dtype))


def nocs_loss(pred_patches: torch.Tensor, gt_patches: torch.Tensor,
              pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
              gt_classes: torch.Tensor, weights: torch.Tensor,
              symmetric_class_ids, loss_weight: float = 3.0
              ) -> torch.Tensor:
    """Masked NOCS loss: pred_patches (N, 28, 28, 3); gt_patches
    (N, P, P, 3) matched GT crops; weights (N,) select the instances.  Sum
    of per-instance losses / #contributing instances * loss_weight
    (`nocs_head.py:123-127`)."""
    losses, valids = nocs_sample_loss(
        pred_patches, gt_patches, pred_boxes, gt_boxes,
        _symmetric(gt_classes, symmetric_class_ids))
    w = weights * valids.to(weights.dtype)
    return (losses * w).sum() / torch.clamp(w.sum(), min=1.0) * loss_weight


def nocs_bin_loss(pred_logits: torch.Tensor, gt_patches: torch.Tensor,
                  pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, weights: torch.Tensor,
                  symmetric_class_ids, num_bins: int = 32,
                  loss_weight: float = 0.2, grid: int = 28) -> torch.Tensor:
    """Bin-classification variant (`train_utils.py:96-172`): per-channel
    cross-entropy of the sampled logits (N, 28, 28, 3, bins) against the
    discretised GT coordinate, symmetry-aware."""
    n = pred_logits.shape[0]
    uu, vv, valid = _overlap_grid(pred_boxes, gt_boxes, grid)
    lg = pred_logits.reshape(n, pred_logits.shape[1], pred_logits.shape[2],
                             -1)
    logp = F.log_softmax(_bilinear_patch_sample(lg, uu, vv, pred_boxes)
                         .reshape(n, grid, grid, 3, num_bins), dim=-1)
    gt_vals = _bilinear_patch_sample(gt_patches, uu, vv, gt_boxes)

    def ce(gt_v):
        tgt = torch.clamp(torch.floor(gt_v * num_bins - 1e-6), 0,
                          num_bins - 1).long()
        return -torch.gather(logp, -1, tgt[..., None]).mean((1, 2, 3, 4))

    l_id = ce(gt_vals)
    l_rot = ce(_rotate_nocs(gt_vals, _Y_ROTATIONS[1]))
    sym = _symmetric(gt_classes, symmetric_class_ids)
    loss = torch.where(sym, torch.minimum(l_id, l_rot), l_id)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    w = weights * valid.to(weights.dtype)
    return (loss * w).sum() / torch.clamp(w.sum(), min=1.0) * loss_weight
