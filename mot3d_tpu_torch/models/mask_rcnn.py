"""Mask R-CNN R50-FPN with NOCS + voxel ROI heads, inference half
(counterpart of `mot3d_tpu/models/mask_rcnn.py`).

Every stage is padded to config maxima with validity masks: proposals,
class-wise NMS and detections are batched over the images, and ROIAlign
pools one image at a time (the JAX package's per-image `lax.map` body; its
"scan" and "unroll" predict modes give identical outputs, so this one loop
serves both).  The heads run once on the batch folded into the leading axis.
Submodule names follow the flax parameter tree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.config import DetectionConfig
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.models.heads import conv_transpose
from mot3d_tpu_torch.models.nocs_head import (NocsBinDecoder, NocsDecoder,
                                              nocs_bins_to_values)
from mot3d_tpu_torch.models.norms import check_norm
from mot3d_tpu_torch.models.resnet_fpn import ResNetFPN
from mot3d_tpu_torch.models.rpn import (RPNHead, decode_deltas,
                                        generate_anchors, level_slices,
                                        select_proposals)
from mot3d_tpu_torch.models.voxel_head import Pix2VoxDecoder
from mot3d_tpu_torch.ops.nms import (classwise_nms_mask, gather_rows,
                                     top_k_by_score)
from mot3d_tpu_torch.ops.roi_align import multilevel_roi_align_packed

STRIDES = (4, 8, 16, 32)          # P2..P5 (ROI pooling levels)
RPN_STRIDES = (4, 8, 16, 32, 64)  # + P6 for proposals


class Detections(NamedTuple):
    """Padded inference output (B, D, ...)."""

    boxes: torch.Tensor    # (B, D, 4)
    scores: torch.Tensor   # (B, D)
    classes: torch.Tensor  # (B, D) int64
    valid: torch.Tensor    # (B, D)
    masks: torch.Tensor    # (B, D, 28, 28) sigmoid probs
    voxels: torch.Tensor   # (B, D, 32, 32, 32) sigmoid probs
    nocs: torch.Tensor     # (B, D, 28, 28, 3) values in [0, 1]


class BoxHead(nn.Module):
    """fc1 contracts the channels-last pooled (7, 7, C) block, as the flax
    head's `fc1_kernel` does."""

    def __init__(self, in_channels: int, pooled: int, num_classes: int,
                 width: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = nn.Linear(pooled * pooled * in_channels, width)
        self.Dense_0 = nn.Linear(width, width)
        self.cls = nn.Linear(width, num_classes + 1)
        self.box = nn.Linear(width, num_classes * 4)

    def forward(self, pooled):  # (N, 7, 7, C)
        x = F.relu(self.fc1(pooled.reshape(pooled.shape[0], -1)))
        x = F.relu(self.Dense_0(x))
        return self.cls(x), self.box(x).reshape(-1, self.num_classes, 4)


class MaskHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, width: int = 256):
        super().__init__()
        for i in range(4):
            self.add_module(f"Conv_{i}", nn.Conv2d(
                in_channels if i == 0 else width, width, 3, padding=1))
        self.ConvTranspose_0 = conv_transpose(2, width, width, 2, 2)
        self.Conv_4 = nn.Conv2d(width, num_classes, 1)

    def forward(self, pooled):  # (N, 14, 14, C) -> (N, 28, 28, classes)
        x = pooled.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = F.relu(self.ConvTranspose_0(x))
        return self.Conv_4(x).permute(0, 2, 3, 1)


def _check_supported(c: DetectionConfig) -> None:
    check_norm(c.norm)
    if c.compute_dtype != "float32":
        raise NotImplementedError(
            f"detection.compute_dtype={c.compute_dtype!r} is not ported "
            "yet: ROADMAP.md Queue 1, item 'bf16 detector compute'")


class MaskRCNN(nn.Module):
    """The detector: `predict(images)` -> `Detections`."""

    def __init__(self, cfg: DetectionConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = c = cfg
        ch = c.fpn_channels
        self.backbone = ResNetFPN(c.backbone_depth, ch, c.backbone_width,
                                  c.norm, c.stride_in_1x1)
        self.rpn_head = RPNHead(ch, len(c.anchor_ratios))
        r = c.box_pooler_resolution
        self.box_head = BoxHead(ch, r, c.num_classes, c.box_head_width)
        self.mask_head = MaskHead(ch, c.num_classes, c.mask_head_width)
        if c.voxel_on:
            self.voxel_head = Pix2VoxDecoder(ch, c.mask_pooler_resolution,
                                             c.head_width_mult, c.norm,
                                             c.voxel_torch_reshape)
        if c.nocs_on:
            self.nocs_head = (NocsBinDecoder(ch, c.nocs_num_bins, c.norm)
                              if c.nocs_use_bin_loss
                              else NocsDecoder(ch, c.norm))
        anchors = generate_anchors(c.pad_height, c.pad_width,
                                   tuple(c.anchor_sizes),
                                   tuple(c.anchor_ratios), RPN_STRIDES,
                                   c.anchor_offset)
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
        self.register_buffer("pixel_mean", torch.tensor(c.pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(c.pixel_std),
                             persistent=False)
        self.register_buffer("box_max", torch.tensor(
            [c.pad_width, c.pad_height, c.pad_width, c.pad_height],
            dtype=torch.float32), persistent=False)
        self.slices = level_slices(c.pad_height, c.pad_width,
                                   len(c.anchor_ratios), RPN_STRIDES)
        self.to(resolve_device(device))

    def features(self, images):
        """images (B, H, W, 3) NHWC pixels -> [P2..P6] (B, C, h, w)."""
        x = (images - self.pixel_mean) / self.pixel_std
        return self.backbone(x.permute(0, 3, 1, 2).contiguous())

    @torch.no_grad()
    def predict(self, images) -> Detections:
        c = self.cfg
        b = images.shape[0]
        feats = self.features(images)
        objness, deltas = self.rpn_head(feats)
        feats4 = feats[:4]
        pb, _, pv = select_proposals(
            self.anchors, objness, deltas, self.slices,
            (c.pad_height, c.pad_width), c.rpn_pre_nms_topk_test,
            c.rpn_post_nms_topk_test, c.rpn_nms_thresh, not c.fast_nms)
        pooled7 = torch.stack([
            multilevel_roi_align_packed([f[i] for f in feats4], pb[i],
                                        c.box_pooler_resolution, STRIDES)
            for i in range(b)])
        p = pb.shape[1]
        cc = c.num_classes
        cls_logits, box_deltas = self.box_head(
            pooled7.reshape((b * p,) + pooled7.shape[2:]))
        probs = torch.softmax(cls_logits.reshape(b, p, -1), -1)[..., :cc]
        boxes_c = decode_deltas(pb[:, :, None, :],
                                box_deltas.reshape(b, p, cc, 4))
        boxes_c = torch.minimum(torch.clamp(boxes_c, min=0.0), self.box_max)
        valid_pc = pv[:, :, None] & (probs > c.score_thresh_test)
        flat_cls = torch.arange(cc, device=pb.device).repeat(p)

        keep = classwise_nms_mask(boxes_c, probs, valid_pc,
                                  c.nms_thresh_test,
                                  not c.fast_nms).reshape(b, p * cc)
        flat_scores = probs.reshape(b, p * cc)
        idx, ok = top_k_by_score(
            torch.where(keep, flat_scores,
                        torch.full_like(flat_scores, -torch.inf)),
            keep, c.detections_per_image)
        det_boxes = gather_rows(boxes_c.reshape(b, p * cc, 4), idx)
        det_scores = torch.where(ok, gather_rows(flat_scores, idx),
                                 torch.zeros_like(ok, dtype=probs.dtype))
        det_cls = flat_cls[idx]
        pooled14 = torch.stack([
            multilevel_roi_align_packed([f[i] for f in feats4], det_boxes[i],
                                        c.mask_pooler_resolution, STRIDES)
            for i in range(b)])
        d = det_boxes.shape[1]
        masks, voxels, nocs = self.dense_heads(
            pooled14.reshape((b * d,) + pooled14.shape[2:]),
            det_cls.reshape(-1))
        return Detections(
            det_boxes, det_scores, det_cls, ok,
            masks.reshape((b, d) + masks.shape[1:]),
            voxels.reshape((b, d) + voxels.shape[1:]),
            nocs.reshape((b, d) + nocs.shape[1:]))

    def dense_heads(self, pooled14, classes):
        """Mask, voxel and NOCS heads on (N, 14, 14, C) pooled features."""
        c = self.cfg
        n = pooled14.shape[0]
        mask_logits = self.mask_head(pooled14)
        sel = torch.clamp(classes, 0, c.num_classes - 1)
        masks = torch.sigmoid(torch.gather(
            mask_logits, -1,
            sel[:, None, None, None].expand(mask_logits.shape[:3] + (1,))
        )[..., 0])
        if c.voxel_on:
            voxels = torch.sigmoid(self.voxel_head(pooled14))
        else:
            voxels = pooled14.new_zeros((n, 32, 32, 32))
        if c.nocs_on:
            nocs = self.nocs_head(pooled14)
            if c.nocs_use_bin_loss:
                nocs = nocs_bins_to_values(nocs, c.nocs_num_bins)
        else:
            nocs = pooled14.new_zeros((n, 28, 28, 3))
        return masks, voxels, nocs
