"""ResNet-50 + FPN backbone (counterpart of `mot3d_tpu/models/resnet_fpn.py`).

GroupNorm throughout (the JAX package's from-scratch default), the stage
stride on the bottleneck's 3x3 convolution, nearest 2x top-down upsampling
and P6 = every second pixel of P5.  Layers are NCHW inside; submodule names
follow the flax parameter tree.  Outputs P2..P6 (strides 4..64), finest
first, each (B, C, h, w).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.models.norms import group_norm


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, channels: int, stride: int = 1):
        super().__init__()
        out_ch = channels * 4
        self.has_proj = stride != 1 or in_ch != out_ch
        if self.has_proj:
            self.proj = nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False)
            self.proj_gn = group_norm(32, out_ch)
        self.Conv_0 = nn.Conv2d(in_ch, channels, 1, bias=False)
        self.GroupNorm_0 = group_norm(32, channels)
        self.Conv_1 = nn.Conv2d(channels, channels, 3, stride=stride,
                                padding=1, bias=False)
        self.GroupNorm_1 = group_norm(32, channels)
        self.Conv_2 = nn.Conv2d(channels, out_ch, 1, bias=False)
        self.GroupNorm_2 = group_norm(32, out_ch)

    def forward(self, x):
        shortcut = self.proj_gn(self.proj(x)) if self.has_proj else x
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = F.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, width_mult: float = 1.0):
        super().__init__()
        blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]

        def w(c):
            return max(32, int(c * width_mult))

        self.stem = nn.Conv2d(3, w(64), 7, stride=2, padding=3, bias=False)
        self.stem_gn = group_norm(32, w(64))
        self.stages: List[List[str]] = []
        in_ch = w(64)
        for stage, (n_blocks, ch) in enumerate(zip(blocks, (64, 128, 256,
                                                            512))):
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"res{stage + 2}_{b}"
                self.add_module(name, Bottleneck(in_ch, w(ch), stride))
                in_ch = w(ch) * 4
                names.append(name)
            self.stages.append(names)
        self.out_channels = [w(ch) * 4 for ch in (64, 128, 256, 512)]

    def forward(self, x):
        x = F.relu(self.stem_gn(self.stem(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats  # C2 (stride 4) .. C5 (stride 32)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")` on the last two axes: output
    index i reads input floor((i + 0.5) * in / out)."""
    for axis, n in zip((-2, -1), size):
        m = x.shape[axis]
        if m != n:
            idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).long()
            x = x.index_select(axis % x.dim(), idx)
    return x


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lat{i + 2}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"post{i + 2}", nn.Conv2d(
                out_channels, out_channels, 3, padding=1))
        self.levels = len(in_channels)

    def forward(self, c_feats):
        laterals = [getattr(self, f"lat{i + 2}")(c)
                    for i, c in enumerate(c_feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            outs.insert(0, lat + resize_nearest(outs[0], lat.shape[-2:]))
        ps = [getattr(self, f"post{i + 2}")(o) for i, o in enumerate(outs)]
        return ps + [ps[-1][..., ::2, ::2]]  # P2..P6


class ResNetFPN(nn.Module):
    def __init__(self, depth: int = 50, out_channels: int = 256,
                 width_mult: float = 1.0):
        super().__init__()
        self.resnet = ResNet(depth, width_mult)
        self.fpn = FPN(self.resnet.out_channels, out_channels)

    def forward(self, images):
        """images (B, 3, H, W) normalised -> [P2..P6] (B, C, h, w)."""
        return self.fpn(self.resnet(images))
