"""Mask R-CNN R50-FPN with NOCS + voxel ROI heads (counterpart of
`mot3d_tpu/models/mask_rcnn.py`).

Every stage is padded to config maxima with validity masks: proposals,
class-wise NMS and detections are batched over the images, and ROIAlign
pools one image at a time (the JAX package's per-image `lax.map` body; its
"scan" and "unroll" predict modes give identical outputs, so this one loop
serves both).  The heads run once on the batch folded into the leading axis.
Submodule names follow the flax parameter tree.

Training (`train_losses`): anchor labelling and sampled RPN losses,
proposals at the train top-k from stop-gradiented RPN outputs, ROI sampling
with the GT boxes appended (`sample_rois`), box classification and
regression on the sampled ROIs, and the mask, voxel and NOCS losses on a
fixed per-image buffer of the foreground ROIs (positives first).  The
random draws of both samplers are an input (`DetectionDraws`).

`detection.compute_dtype="bfloat16"` runs the backbone, the RPN head and
the box, mask, voxel and NOCS heads in bfloat16 with float32 parameters
(flax's `dtype=`, `models/norms.py:compute_in`): the FPN features and every
head's outputs come back as float32, so ROIAlign, proposal selection, NMS
and everything after the detector stay float32.  A float32 state_dict
loads unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.config import DetectionConfig
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.geometry.iou3d import box2d_iou_matrix
from mot3d_tpu_torch.models.heads import conv_transpose
from mot3d_tpu_torch.models.nocs_head import (NocsBinDecoder, NocsDecoder,
                                              nocs_bin_loss,
                                              nocs_bins_to_values, nocs_loss)
from mot3d_tpu_torch.models.norms import (check_norm, compute_dtype,
                                          compute_in)
from mot3d_tpu_torch.models.resnet_fpn import ResNetFPN
from mot3d_tpu_torch.models.rpn import (RPNHead, decode_deltas,
                                        encode_deltas, generate_anchors,
                                        label_anchors, level_slices,
                                        rpn_losses, select_proposals,
                                        smooth_l1, softplus,
                                        subsample_labels)
from mot3d_tpu_torch.models.voxel_head import Pix2VoxDecoder, voxel_loss
from mot3d_tpu_torch.ops.nms import (classwise_nms_mask, gather_rows,
                                     top_k_by_score)
from mot3d_tpu_torch.ops.roi_align import (
    multilevel_roi_align_batched_packed, roi_align_matmul)
from mot3d_tpu_torch.utils import trace

STRIDES = (4, 8, 16, 32)          # P2..P5 (ROI pooling levels)
RPN_STRIDES = (4, 8, 16, 32, 64)  # + P6 for proposals


class GroundTruth(NamedTuple):
    """Padded per-image ground truth (leading batch dim B)."""

    boxes: torch.Tensor    # (B, M, 4) XYXY
    classes: torch.Tensor  # (B, M) int
    valid: torch.Tensor    # (B, M) bool
    masks: torch.Tensor    # (B, M, H, W) {0, 1}
    voxels: torch.Tensor   # (B, M, 32, 32, 32)
    nocs: torch.Tensor     # (B, M, P, P, 3) normalised GT NOCS crops


class DetectionDraws(NamedTuple):
    """Uniform [0, 1) draws of one training forward (leading batch dim B):
    one per anchor for the RPN's subsampling and one per ROI candidate
    (proposals, then GT boxes) for `sample_rois`, where the JAX package
    draws both from a key split per image."""

    rpn: torch.Tensor      # (B, A)
    roi: torch.Tensor      # (B, P + M)


class SampledRois(NamedTuple):
    boxes: torch.Tensor       # (B, R, 4)
    valid: torch.Tensor       # (B, R) bool
    is_pos: torch.Tensor      # (B, R) float {0, 1}
    gt_class: torch.Tensor    # (B, R) matched class (0-based)
    matched_gt: torch.Tensor  # (B, R) index into the GT slots


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
    head's `fc1_kernel` does.  With a compute dtype the layers run in it
    and the logits and deltas, which feed the score thresholds and box
    decoding, are cast to float32."""

    def __init__(self, in_channels: int, pooled: int, num_classes: int,
                 width: int = 1024, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.fc1 = nn.Linear(pooled * pooled * in_channels, width)
        self.Dense_0 = nn.Linear(width, width)
        self.cls = nn.Linear(width, num_classes + 1)
        self.box = nn.Linear(width, num_classes * 4)

    def forward(self, pooled):  # (N, 7, 7, C)
        x = pooled.reshape(pooled.shape[0], -1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(compute_in(self.fc1, x))
        x = F.relu(compute_in(self.Dense_0, x))
        logits, deltas = compute_in(self.cls, x), compute_in(self.box, x)
        if self.dtype is not None:
            logits, deltas = logits.float(), deltas.float()
        return logits, deltas.reshape(-1, self.num_classes, 4)


class MaskHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, width: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        for i in range(4):
            self.add_module(f"Conv_{i}", nn.Conv2d(
                in_channels if i == 0 else width, width, 3, padding=1))
        self.ConvTranspose_0 = conv_transpose(2, width, width, 2, 2)
        self.Conv_4 = nn.Conv2d(width, num_classes, 1)

    def forward(self, pooled):  # (N, 14, 14, C) -> (N, 28, 28, classes)
        x = pooled.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i in range(4):
            x = F.relu(compute_in(getattr(self, f"Conv_{i}"), x))
        x = F.relu(compute_in(self.ConvTranspose_0, x))
        x = compute_in(self.Conv_4, x)
        if self.dtype is not None:
            x = x.float()
        return x.permute(0, 2, 3, 1)


class MaskRCNN(nn.Module):
    """The detector: `predict(images)` -> `Detections`."""

    def __init__(self, cfg: DetectionConfig, device=None):
        super().__init__()
        check_norm(cfg.norm)
        dt = compute_dtype(cfg.compute_dtype)
        self.cfg = c = cfg
        ch = c.fpn_channels
        self.backbone = ResNetFPN(c.backbone_depth, ch, c.backbone_width,
                                  c.norm, c.stride_in_1x1, dt)
        self.rpn_head = RPNHead(ch, len(c.anchor_ratios), dt)
        r = c.box_pooler_resolution
        self.box_head = BoxHead(ch, r, c.num_classes, c.box_head_width, dt)
        self.mask_head = MaskHead(ch, c.num_classes, c.mask_head_width, dt)
        if c.voxel_on:
            self.voxel_head = Pix2VoxDecoder(ch, c.mask_pooler_resolution,
                                             c.head_width_mult, c.norm,
                                             c.voxel_torch_reshape, dt)
        if c.nocs_on:
            self.nocs_head = (NocsBinDecoder(ch, c.nocs_num_bins, c.norm, dt)
                              if c.nocs_use_bin_loss
                              else NocsDecoder(ch, c.norm, dt))
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

    def num_proposals_train(self) -> int:
        """Proposals per image of a training forward (the length P of the
        ROI sampler's draws before the GT boxes)."""
        c = self.cfg
        cands = sum(min(c.rpn_pre_nms_topk_train, s1 - s0)
                    for s0, s1 in self.slices)
        return min(c.rpn_post_nms_topk_train, cands)

    def make_draws(self, batch: int, generator: Optional[torch.Generator]
                   = None) -> DetectionDraws:
        """The draws of one training forward on `batch` images, made on
        the model's device in its dtype."""
        kw = dict(generator=generator, device=self.anchors.device,
                  dtype=self.anchors.dtype)
        return DetectionDraws(
            torch.rand((batch, self.anchors.shape[0]), **kw),
            torch.rand((batch, self.num_proposals_train()
                        + self.cfg.max_instances), **kw))

    # ----------------------------------------------------------- training

    def train_losses(self, images, gt: GroundTruth, draws: DetectionDraws,
                     feats=None) -> dict:
        """Full training forward -> dict of losses (and `voxel_iou`), the
        JAX package's keys.  `feats` are this model's `features(images)`
        when the caller has them already."""
        c = self.cfg
        b = images.shape[0]
        if feats is None:
            feats = self.features(images)
        objness, deltas = self.rpn_head(feats)
        anchors = self.anchors

        targets = label_anchors(anchors, gt.boxes, gt.valid, c.rpn_pos_iou,
                                c.rpn_neg_iou)
        obj_ls, box_ls = rpn_losses(objness, deltas, anchors, targets,
                                    draws.rpn, c.rpn_batch_per_image,
                                    c.rpn_positive_fraction)
        pb, _, pv = select_proposals(
            anchors, objness.detach(), deltas.detach(), self.slices,
            (c.pad_height, c.pad_width), c.rpn_pre_nms_topk_train,
            c.rpn_post_nms_topk_train, c.rpn_nms_thresh, not c.fast_nms)

        # --- ROI sampling + box head on the folded (B*R, ...) batch ---
        samples = sample_rois(pb, pv, gt.boxes, gt.classes, gt.valid,
                              draws.roi, c)
        feats4 = feats[:4]
        rr = samples.boxes.shape[1]
        pooled7 = multilevel_roi_align_batched_packed(
            feats4, samples.boxes, c.box_pooler_resolution, STRIDES)
        pooled7 = pooled7.reshape((b * rr,) + pooled7.shape[2:])
        boxes_all = samples.boxes.reshape(b * rr, 4)
        valid_all = samples.valid.reshape(-1).to(pooled7.dtype)
        is_pos_all = samples.is_pos.reshape(-1)
        cls_all = samples.gt_class.reshape(-1).long()
        matched_boxes = gather_rows(gt.boxes, samples.matched_gt).reshape(
            b * rr, 4)

        cls_logits, box_deltas = self.box_head(pooled7)

        # Classification: background class = num_classes.
        labels = torch.where(is_pos_all > 0, cls_all,
                             torch.full_like(cls_all, c.num_classes))
        logp = torch.log_softmax(cls_logits, -1)
        ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
        n_valid = torch.clamp(valid_all.sum(), min=1.0)
        cls_loss = (ce * valid_all).sum() / n_valid

        # Class-specific box regression on positives.
        sel = torch.clamp(cls_all, 0, c.num_classes - 1)
        sel_deltas = torch.gather(
            box_deltas, 1, sel[:, None, None].expand(-1, 1, 4))[:, 0]
        gt_d = encode_deltas(boxes_all, matched_boxes)
        box_l = smooth_l1(sel_deltas - gt_d).sum(-1)
        box_loss = (box_l * is_pos_all).sum() / n_valid

        # --- per-image foreground buffer for the mask/voxel/NOCS branches:
        # k_im covers every possible positive (the sampler caps positives
        # at roi_batch_per_image * roi_positive_fraction), so only
        # always-masked background rows are dropped.
        n_pos_cap = int(c.roi_batch_per_image * c.roi_positive_fraction)
        if c.fg_head_buffer < n_pos_cap:
            raise ValueError(
                f"fg_head_buffer ({c.fg_head_buffer}) must cover the "
                f"sampler's positive cap roi_batch_per_image * "
                f"roi_positive_fraction = {n_pos_cap}; a smaller buffer "
                f"silently drops positives from the mask/voxel/NOCS losses")
        k_im = min(rr, c.fg_head_buffer)
        fg_rank_im = torch.argsort((samples.is_pos <= 0).to(torch.uint8),
                                   dim=1, stable=True)[:, :k_im]
        fg_boxes_im = gather_rows(samples.boxes, fg_rank_im)   # (B, K, 4)
        fg_matched_im = torch.gather(samples.matched_gt, 1, fg_rank_im)
        pooled14 = multilevel_roi_align_batched_packed(
            feats4, fg_boxes_im, c.mask_pooler_resolution, STRIDES)
        pooled14 = pooled14.reshape((b * k_im,) + pooled14.shape[2:])
        fg_is_pos = torch.gather(samples.is_pos, 1, fg_rank_im).reshape(-1)
        fg_cls_all = torch.gather(samples.gt_class, 1,
                                  fg_rank_im).reshape(-1).long()
        fg_matched_all = fg_matched_im.reshape(-1)
        fg_boxes_all = fg_boxes_im.reshape(b * k_im, 4)
        fg_gt_boxes_all = gather_rows(gt.boxes, fg_matched_im).reshape(
            b * k_im, 4)

        # Mask loss; targets pool all GT masks of an image as channels of
        # one ROIAlign and keep each box's matched one.
        mask_logits = self.mask_head(pooled14)
        msel = torch.clamp(fg_cls_all, 0, c.num_classes - 1)
        sel_mask = torch.gather(
            mask_logits, -1,
            msel[:, None, None, None].expand(mask_logits.shape[:3] + (1,))
        )[..., 0]                                       # (B*K, 28, 28)
        mask_tgt = torch.stack([
            torch.gather(
                roi_align_matmul(gt.masks[i].to(pooled14.dtype)
                                 .permute(1, 2, 0), fg_boxes_im[i], 28),
                -1, fg_matched_im[i][:, None, None, None].expand(
                    -1, 28, 28, 1))[..., 0]
            for i in range(b)])
        mask_tgt = (mask_tgt.reshape(b * k_im, 28, 28) >= 0.5).to(
            sel_mask.dtype)
        mask_bce = (mask_tgt * softplus(-sel_mask)
                    + (1 - mask_tgt) * softplus(sel_mask)).mean((1, 2))
        n_pos = torch.clamp(fg_is_pos.sum(), min=1.0)
        mask_loss = (mask_bce * fg_is_pos).sum() / n_pos

        losses = {
            "loss_rpn_cls": obj_ls.mean(),
            "loss_rpn_loc": box_ls.mean(),
            "loss_cls": cls_loss,
            "loss_box_reg": box_loss,
            "loss_mask": mask_loss,
        }

        # --- voxel + NOCS heads on a fixed buffer of the top positives
        # (positives first, image-0-major: a stable sort) ---
        if c.voxel_on or c.nocs_on:
            k_fg = min(c.fg_head_buffer, pooled14.shape[0])
            fg_rank = torch.argsort((fg_is_pos <= 0).to(torch.uint8),
                                    stable=True)[:k_fg]
            fg_pooled = pooled14[fg_rank]
            fg_w = fg_is_pos[fg_rank]
            fg_cls = fg_cls_all[fg_rank]
            fg_boxes = fg_boxes_all[fg_rank]
            fg_gt_boxes = fg_gt_boxes_all[fg_rank]
            img_of = torch.arange(
                b, device=fg_rank.device).repeat_interleave(k_im)[fg_rank]
            fg_matched = fg_matched_all[fg_rank]

            if c.voxel_on:
                vox_logits = self.voxel_head(fg_pooled)
                vl, viou = voxel_loss(vox_logits,
                                      gt.voxels[img_of, fg_matched], fg_w,
                                      c.voxel_loss_weight)
                losses["loss_voxel"] = vl
                losses["voxel_iou"] = viou
            if c.nocs_on:
                fg_gt_nocs = gt.nocs[img_of, fg_matched].to(fg_pooled.dtype)
                # Symmetric classes: 'table' (id 1 in MOTFRONT_CLASSES).
                sym = (1,)
                if c.nocs_use_bin_loss:
                    losses["loss_nocs"] = nocs_bin_loss(
                        self.nocs_head(fg_pooled), fg_gt_nocs, fg_boxes,
                        fg_gt_boxes, fg_cls, fg_w, sym, c.nocs_num_bins,
                        c.nocs_loss_weight)
                else:
                    losses["loss_nocs"] = nocs_loss(
                        self.nocs_head(fg_pooled), fg_gt_nocs, fg_boxes,
                        fg_gt_boxes, fg_cls, fg_w, sym, c.nocs_loss_weight)
        return losses

    # ---------------------------------------------------------- inference

    @torch.no_grad()
    def predict(self, images) -> Detections:
        """Serving: `predict_features` on `features(images)` without
        autograd."""
        with trace.span("detect.backbone"):
            feats = self.features(images)
        return self.predict_features(feats)

    def predict_features(self, feats) -> Detections:
        """Inference from the FPN features of a batch of images, with
        autograd when it is enabled: the training step's second pass, whose
        NOCS, boxes and masks carry the tracking loss's gradient back into
        the detector under `pose.differentiable=True`."""
        c = self.cfg
        b = feats[0].shape[0]
        feats4 = feats[:4]
        with trace.span("detect.rpn"):
            objness, deltas = self.rpn_head(feats)
            pb, _, pv = select_proposals(
                self.anchors, objness, deltas, self.slices,
                (c.pad_height, c.pad_width), c.rpn_pre_nms_topk_test,
                c.rpn_post_nms_topk_test, c.rpn_nms_thresh, not c.fast_nms)
        with trace.span("detect.box"):
            pooled7 = multilevel_roi_align_batched_packed(
                feats4, pb, c.box_pooler_resolution, STRIDES)
            p = pb.shape[1]
            cc = c.num_classes
            cls_logits, box_deltas = self.box_head(
                pooled7.reshape((b * p,) + pooled7.shape[2:]))
            probs = torch.softmax(cls_logits.reshape(b, p, -1), -1)[..., :cc]
            boxes_c = decode_deltas(pb[:, :, None, :],
                                    box_deltas.reshape(b, p, cc, 4))
            boxes_c = torch.minimum(torch.clamp(boxes_c, min=0.0),
                                    self.box_max)
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
        with trace.span("detect.heads"):
            pooled14 = multilevel_roi_align_batched_packed(
                feats4, det_boxes, c.mask_pooler_resolution, STRIDES)
            d = det_boxes.shape[1]
            masks, voxels, nocs = self.dense_heads(
                pooled14.reshape((b * d,) + pooled14.shape[2:]),
                det_cls.reshape(-1))
        return Detections(
            det_boxes, det_scores, det_cls, ok,
            masks.reshape((b, d) + masks.shape[1:]),
            voxels.reshape((b, d) + voxels.shape[1:]),
            nocs.reshape((b, d) + nocs.shape[1:]))

    @torch.no_grad()
    def predict_given_boxes(self, images, boxes, classes):
        """Mask, voxel and NOCS heads on externally supplied boxes
        (forward_with_given_boxes_voxnocs, `roi_heads.py:116-135`):
        images (B, H, W, 3), boxes (B, D, 4), classes (B, D) ->
        (masks, voxels, nocs) with leading (B, D)."""
        feats = self.features(images)
        b, d = boxes.shape[:2]
        pooled14 = multilevel_roi_align_batched_packed(
            feats[:4], boxes, self.cfg.mask_pooler_resolution, STRIDES)
        outs = self.dense_heads(
            pooled14.reshape((b * d,) + pooled14.shape[2:]),
            classes.reshape(-1))
        return tuple(x.reshape((b, d) + x.shape[1:]) for x in outs)

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


def sample_rois(prop_boxes, prop_valid, gt_boxes, gt_classes, gt_valid,
                rand, cfg: DetectionConfig) -> SampledRois:
    """Proposal-GT matching and fixed-count sampling, batched over images:
    prop_boxes (B, P, 4), prop_valid (B, P), gt_* (B, M, ...), rand
    (B, P + M) uniform draws.

    detectron2 semantics with IOU_THRESHOLDS [0.75] / POSITIVE_FRACTION 0.2
    (`cfg_setup.py:63-66`): the GT boxes are appended to the proposals,
    positives have max IoU >= 0.75, everything else is background.  The
    selected ROIs are compacted into (B, roi_batch_per_image), positives
    first; `rand` also breaks the ties of that order, as the JAX package's
    second draw from the same key does."""
    boxes = torch.cat([prop_boxes, gt_boxes], 1)
    valid = torch.cat([prop_valid, gt_valid], 1)
    iou = box2d_iou_matrix(boxes, gt_boxes)                   # (B, P+M, M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    matched = torch.argmax(iou, -1)
    max_iou = iou.amax(-1)
    labels = torch.where(max_iou >= cfg.roi_iou_threshold, 1, 0)
    labels = torch.where(valid, labels, -1)

    pos_sel, neg_sel = subsample_labels(labels, rand,
                                        cfg.roi_batch_per_image,
                                        cfg.roi_positive_fraction)
    sel = pos_sel | neg_sel
    score = torch.where(pos_sel, 2.0, torch.where(neg_sel, 1.0, 0.0)).to(
        rand.dtype) + rand * 1e-3
    num_rois = min(cfg.roi_batch_per_image, boxes.shape[1])
    idx, ok = top_k_by_score(score, sel, num_rois)
    matched_i = torch.gather(matched, 1, idx)
    return SampledRois(
        boxes=gather_rows(boxes, idx),
        valid=ok & torch.gather(sel, 1, idx),
        is_pos=torch.gather(pos_sel, 1, idx).to(prop_boxes.dtype),
        gt_class=torch.clamp(torch.gather(gt_classes, 1, matched_i), min=0),
        matched_gt=matched_i)
