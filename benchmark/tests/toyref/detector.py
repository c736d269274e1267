"""The reference's Mask R-CNN with the finest pyramid level (P2) passed
through a LayerNorm over channels and a bare channel-mixing matrix: one
module class and one parameter kind that `benchmark.reference` lacks.
Everything else is the reference's."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.models import mask_rcnn as base

# The harness takes these from the detector's module.
DetectionDraws, GroundTruth = base.DetectionDraws, base.GroundTruth


class MaskRCNN(base.MaskRCNN):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device=device)
        ch = cfg.fpn_channels
        self.feature_norm = nn.LayerNorm(ch, eps=cfg.feature_norm_eps,
                                         device=device)
        self.feature_mix = nn.Parameter(torch.empty((ch, ch), device=device))

    def features(self, images):
        p2, *rest = super().features(images)
        p2 = self.feature_norm(p2.permute(0, 2, 3, 1))
        p2 = torch.einsum("bhwc,cd->bdhw", p2, self.feature_mix)
        return [p2.contiguous(), *rest]
