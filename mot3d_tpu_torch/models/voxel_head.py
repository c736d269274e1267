"""Voxel reconstruction ROI head (counterpart of
`mot3d_tpu/models/voxel_head.py:Pix2VoxDecoder`).

Pooled ROI features (N, 14, 14, C) become a 4 x 4 x 4 volume of
196 C / 64 channels, then five transposed 3D convolutions (norm + ReLU
after the first four) decode (N, 32, 32, 32) occupancy logits.  The
default reshape is the flax model's channels-last one; `torch_reshape=True`
(with norm="affine", for imported reference weights) groups the
channel-major flat index instead, as the reference's `view()` of an
(N, C, 14, 14) tensor into (N, 196 C / 64, 4, 4, 4) does.

`voxel_loss` is the reference's per-instance loop (max-IoU GT match,
balanced BCE over the selected instances) as one masked batched op.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.geometry.iou3d import voxel_iou
from mot3d_tpu_torch.models.heads import conv_transpose
from mot3d_tpu_torch.models.norms import compute_in, make_norm, norm_name
from mot3d_tpu_torch.models.rpn import softplus


class Pix2VoxDecoder(nn.Module):
    def __init__(self, in_channels: int, pooled: int = 14,
                 width_mult: float = 1.0, norm: str = "gn",
                 torch_reshape: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.torch_reshape = torch_reshape
        self.dtype = dtype

        def w(c):
            return max(8, int(c * width_mult))

        vol_ch = pooled * pooled * in_channels // 64
        chans = (vol_ch, w(512), w(128), w(32), w(8), 1)
        kernels = (3, 4, 4, 4, 1)
        strides = (1, 2, 2, 2, 1)
        for i in range(5):
            self.add_module(f"ConvTranspose_{i}", conv_transpose(
                3, chans[i], chans[i + 1], kernels[i], strides[i]))
        self.norms = [norm_name(norm, i) for i in range(4)]
        for i, name in enumerate(self.norms):
            self.add_module(name, make_norm(norm, min(8, chans[i + 1]),
                                            chans[i + 1]))

    def forward(self, x):
        """(N, 14, 14, C) -> (N, 32, 32, 32) logits (float32 under a
        compute dtype: they feed the losses)."""
        n = x.shape[0]
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.torch_reshape:
            vol = x.permute(0, 3, 1, 2).reshape(n, -1, 4, 4, 4)
        else:
            vol = x.reshape(n, 4, 4, 4, -1).permute(0, 4, 1, 2, 3)
        for i, name in enumerate(self.norms):
            vol = compute_in(getattr(self, f"ConvTranspose_{i}"), vol)
            vol = F.relu(compute_in(getattr(self, name), vol))
        out = compute_in(self.ConvTranspose_4, vol)[:, 0]
        return out if self.dtype is None else out.float()


def voxel_loss(pred_logits: torch.Tensor, gt_voxels: torch.Tensor,
               weights: torch.Tensor, loss_weight: float = 0.75):
    """Balanced BCE over selected instances.

    pred_logits, gt_voxels (N, 32, 32, 32); weights (N,) in {0, 1}.
    pos_weight = #empty / #occupied over the selected GT voxels
    (`Detection/utils/train_utils.py:18-31`).  Returns (loss, mean voxel IoU
    of the selected instances)."""
    wv = weights.to(pred_logits.dtype)
    w = wv[:, None, None, None]
    gt = gt_voxels.to(pred_logits.dtype)
    occupied = (gt * w).sum()
    total = wv.sum() * gt[0].numel()
    pos_weight = torch.where(occupied > 0,
                             (total - occupied) / torch.clamp(occupied,
                                                              min=1.0),
                             torch.ones_like(occupied))
    per_vox = (pos_weight * gt * softplus(-pred_logits)
               + (1.0 - gt) * softplus(pred_logits))
    loss = (per_vox * w).sum() / torch.clamp(total, min=1.0)

    ious = voxel_iou(torch.sigmoid(pred_logits), gt)
    mean_iou = (ious * wv).sum() / torch.clamp(wv.sum(), min=1.0)
    return loss * loss_weight, mean_iou
