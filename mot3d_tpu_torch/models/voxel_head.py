"""Voxel reconstruction ROI head (counterpart of
`mot3d_tpu/models/voxel_head.py:Pix2VoxDecoder`, gn mode).

Pooled ROI features (N, 14, 14, C) are reshaped channels-last into a
(4, 4, 4, 196 C / 64) volume — the flax model's NHWC reshape — then five
transposed 3D convolutions (GroupNorm + ReLU after the first four) decode
(N, 32, 32, 32) occupancy logits.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.models.heads import conv_transpose
from mot3d_tpu_torch.models.norms import group_norm


class Pix2VoxDecoder(nn.Module):
    def __init__(self, in_channels: int, pooled: int = 14,
                 width_mult: float = 1.0):
        super().__init__()

        def w(c):
            return max(8, int(c * width_mult))

        vol_ch = pooled * pooled * in_channels // 64
        chans = (vol_ch, w(512), w(128), w(32), w(8), 1)
        kernels = (3, 4, 4, 4, 1)
        strides = (1, 2, 2, 2, 1)
        for i in range(5):
            self.add_module(f"ConvTranspose_{i}", conv_transpose(
                3, chans[i], chans[i + 1], kernels[i], strides[i]))
            if i < 4:
                self.add_module(f"GroupNorm_{i}",
                                group_norm(min(8, chans[i + 1]),
                                           chans[i + 1]))

    def forward(self, x):
        """(N, 14, 14, C) -> (N, 32, 32, 32) logits."""
        n = x.shape[0]
        vol = x.reshape(n, 4, 4, 4, -1).permute(0, 4, 1, 2, 3)
        for i in range(4):
            vol = getattr(self, f"ConvTranspose_{i}")(vol)
            vol = F.relu(getattr(self, f"GroupNorm_{i}")(vol))
        return self.ConvTranspose_4(vol)[:, 0]
