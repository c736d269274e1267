"""NOCS (normalised object coordinate) ROI head (counterpart of
`mot3d_tpu/models/nocs_head.py:NocsDecoder`, regression mode with gn).

(N, 14, 14, C) pooled features -> three transposed-conv blocks
(ConvTranspose -> GroupNorm(32) -> ReLU; 256, 128, 64 channels, the last
one 2x up) -> a 3-channel transposed conv -> sigmoid: (N, 28, 28, 3) in
[0, 1].  The bin-classification variant is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.models.heads import conv_transpose
from mot3d_tpu_torch.models.norms import group_norm


class NocsDecoder(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        chans = (in_channels, 256, 128, 64, 3)
        kernels = (3, 3, 4, 3)
        strides = (1, 1, 2, 1)
        for i in range(4):
            self.add_module(f"ConvTranspose_{i}", conv_transpose(
                2, chans[i], chans[i + 1], kernels[i], strides[i]))
            if i < 3:
                self.add_module(f"GroupNorm_{i}", group_norm(32, chans[i + 1]))

    def forward(self, x):
        """(N, 14, 14, C) -> (N, 28, 28, 3)."""
        x = x.permute(0, 3, 1, 2)
        for i in range(3):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = F.relu(getattr(self, f"GroupNorm_{i}")(x))
        x = self.ConvTranspose_3(x)
        return torch.sigmoid(x).permute(0, 2, 3, 1)
