"""NOCS (normalised object coordinate) ROI heads (counterpart of
`mot3d_tpu/models/nocs_head.py`, inference half).

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.models.heads import conv_transpose
from mot3d_tpu_torch.models.norms import make_norm, norm_name


def _norm_act(norm_layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(norm_layer, nn.GroupNorm):
        return F.relu(norm_layer(x))
    return norm_layer(F.relu(x))


class NocsDecoder(nn.Module):
    def __init__(self, in_channels: int, norm: str = "gn"):
        super().__init__()
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
        """(N, 14, 14, C) -> (N, 28, 28, 3)."""
        x = x.permute(0, 3, 1, 2)
        for i, name in enumerate(self.norms):
            x = _norm_act(getattr(self, name),
                          getattr(self, f"ConvTranspose_{i}")(x))
        x = self.ConvTranspose_3(x)
        return torch.sigmoid(x).permute(0, 2, 3, 1)


class NocsBinDecoder(nn.Module):
    """Towers `l1_c -> l2_c -> l3_c` for c in r, g, b (128, 64 and `num_bins`
    channels, the middle one 2x up); the flax model numbers the towers'
    norm layers 0..5 in that order."""

    def __init__(self, in_channels: int, num_bins: int = 32,
                 norm: str = "gn"):
        super().__init__()
        self.norms = [norm_name(norm, i) for i in range(6)]
        for t, ch in enumerate("rgb"):
            self.add_module(f"l1_{ch}", conv_transpose(2, in_channels, 128, 3))
            self.add_module(self.norms[2 * t], make_norm(norm, 32, 128))
            self.add_module(f"l2_{ch}", conv_transpose(2, 128, 64, 4, 2))
            self.add_module(self.norms[2 * t + 1], make_norm(norm, 32, 64))
            self.add_module(f"l3_{ch}", conv_transpose(2, 64, num_bins, 3))

    def forward(self, x):
        """(N, 14, 14, C) -> (N, 28, 28, 3, bins) logits."""
        x = x.permute(0, 3, 1, 2)
        outs = []
        for t, ch in enumerate("rgb"):
            y = _norm_act(getattr(self, self.norms[2 * t]),
                          getattr(self, f"l1_{ch}")(x))
            y = _norm_act(getattr(self, self.norms[2 * t + 1]),
                          getattr(self, f"l2_{ch}")(y))
            outs.append(getattr(self, f"l3_{ch}")(y).permute(0, 2, 3, 1))
        return torch.stack(outs, dim=-2)


def nocs_bins_to_values(logits: torch.Tensor, num_bins: int = 32
                        ) -> torch.Tensor:
    """(..., 3, bins) logits -> (..., 3) values: argmax bin / (bins - 1);
    ties take the first bin."""
    idx = torch.argmax(logits, dim=-1)
    return idx.to(logits.dtype) / (num_bins - 1)
