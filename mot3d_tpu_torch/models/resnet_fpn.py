"""ResNet-50 + FPN backbone (counterpart of `mot3d_tpu/models/resnet_fpn.py`).

norm="gn" (GroupNorm, the JAX package's from-scratch default) or "affine"
(frozen per-channel scale + bias, for imported reference weights); the
stage stride on the bottleneck's 3x3 convolution, or on its first 1x1 with
`stride_in_1x1` (detectron2's caffe-style R50, which imported weights
need); nearest 2x top-down upsampling and P6 = every second pixel of P5.
Layers are NCHW inside; submodule names follow the flax parameter tree (the
unnamed norm layers are `GroupNorm_i` or `AffineChannelNorm_i` by mode).
Outputs P2..P6 (strides 4..64), finest first, each (B, C, h, w).  With a
compute dtype (bfloat16) the image is cast to it on entry, every layer runs
in it through `norms.compute_in`, and the outputs are cast back to float32,
as the flax backbone does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.models.norms import compute_in, make_norm, norm_name


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 norm: str = "gn", stride_in_1x1: bool = False):
        super().__init__()
        out_ch = channels * 4
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.has_proj = stride != 1 or in_ch != out_ch
        if self.has_proj:
            self.proj = nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False)
            self.proj_gn = make_norm(norm, 32, out_ch)
        self.Conv_0 = nn.Conv2d(in_ch, channels, 1, stride=s1, bias=False)
        self.Conv_1 = nn.Conv2d(channels, channels, 3, stride=s3,
                                padding=1, bias=False)
        self.Conv_2 = nn.Conv2d(channels, out_ch, 1, bias=False)
        self.norms = [norm_name(norm, i) for i in range(3)]
        for name, ch in zip(self.norms, (channels, channels, out_ch)):
            self.add_module(name, make_norm(norm, 32, ch))

    def forward(self, x):
        c = compute_in
        n0, n1, n2 = (getattr(self, name) for name in self.norms)
        shortcut = (c(self.proj_gn, c(self.proj, x)) if self.has_proj
                    else x)
        y = F.relu(c(n0, c(self.Conv_0, x)))
        y = F.relu(c(n1, c(self.Conv_1, y)))
        y = c(n2, c(self.Conv_2, y))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, width_mult: float = 1.0,
                 norm: str = "gn", stride_in_1x1: bool = False):
        super().__init__()
        blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]

        def w(c):
            return max(32, int(c * width_mult))

        self.stem = nn.Conv2d(3, w(64), 7, stride=2, padding=3, bias=False)
        self.stem_gn = make_norm(norm, 32, w(64))
        self.stages: List[List[str]] = []
        in_ch = w(64)
        for stage, (n_blocks, ch) in enumerate(zip(blocks, (64, 128, 256,
                                                            512))):
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"res{stage + 2}_{b}"
                self.add_module(name, Bottleneck(in_ch, w(ch), stride, norm,
                                                  stride_in_1x1))
                in_ch = w(ch) * 4
                names.append(name)
            self.stages.append(names)
        self.out_channels = [w(ch) * 4 for ch in (64, 128, 256, 512)]

    def forward(self, x):
        x = F.relu(compute_in(self.stem_gn, compute_in(self.stem, x)))
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
        laterals = [compute_in(getattr(self, f"lat{i + 2}"), c)
                    for i, c in enumerate(c_feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            outs.insert(0, lat + resize_nearest(outs[0], lat.shape[-2:]))
        ps = [compute_in(getattr(self, f"post{i + 2}"), o)
              for i, o in enumerate(outs)]
        return ps + [ps[-1][..., ::2, ::2]]  # P2..P6


class ResNetFPN(nn.Module):
    def __init__(self, depth: int = 50, out_channels: int = 256,
                 width_mult: float = 1.0, norm: str = "gn",
                 stride_in_1x1: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.resnet = ResNet(depth, width_mult, norm, stride_in_1x1)
        self.fpn = FPN(self.resnet.out_channels, out_channels)

    def forward(self, images):
        """images (B, 3, H, W) normalised -> [P2..P6] (B, C, h, w)."""
        if self.dtype is None:
            return self.fpn(self.resnet(images))
        return [p.float() for p in self.fpn(self.resnet(images.to(
            self.dtype)))]
