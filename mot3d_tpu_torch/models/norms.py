"""Normalisation layers for the detection model (counterpart of
`mot3d_tpu/models/norms.py`).

Two modes, selected by `DetectionConfig.norm`:

  - "gn" (default): GroupNorm over contiguous channel groups, with flax's
    epsilon of 1e-6 (torch's default is 1e-5);
  - "affine": frozen per-channel scale + bias, the inference form of the
    reference's FrozenBatchNorm2d / eval-mode BatchNorm (folded statistics),
    used for detectors imported from the reference's checkpoints.

Both kinds of layer name their parameters `weight` and `bias`, so a flax
`scale` leaf maps to `weight` whichever mode built the module.

Reduced-precision compute (`detection.compute_dtype="bfloat16"`, flax's
`dtype=`): parameters stay float32 and every layer is called through
`compute_in`, which casts them to the input's dtype per call; GroupNorm
takes its statistics and affine in float32 and returns the input's dtype,
as flax's does.
"""

from __future__ import annotations

import torch
from torch import nn

GN_EPS = 1e-6


def compute_dtype(name: str):
    """`detection.compute_dtype` -> the torch dtype the detector's layers
    compute in, or None for their parameters' own dtype."""
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unknown detection.compute_dtype {name!r} (expected "
                     f"'float32' or 'bfloat16')")


def compute_in(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`layer(x)` in x's dtype: the layer's own call when its parameters
    have that dtype, else with them cast to it for this call (autograd
    reaches the float32 parameters through the cast); a GroupNorm
    normalises x in its parameters' dtype and casts the result back."""
    w = layer.weight
    if w.dtype == x.dtype:
        return layer(x)
    if isinstance(layer, nn.GroupNorm):
        return layer(x.to(w.dtype)).to(x.dtype)
    return torch.func.functional_call(
        layer, {n: p.to(x.dtype) for n, p in layer.named_parameters()},
        (x,))


def check_norm(norm: str) -> None:
    if norm not in ("gn", "affine"):
        raise ValueError(f"unknown norm {norm!r} (expected 'gn' or 'affine')")


def group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=GN_EPS)


class AffineChannelNorm(nn.Module):
    """x * weight + bias per channel, channels on axis 1 (the port's layers
    are channel-first inside; the flax layer works on the trailing axis)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * self.weight.view(shape) + self.bias.view(shape)


def make_norm(norm: str, groups: int, channels: int) -> nn.Module:
    """The configured norm layer: "gn" -> GroupNorm, "affine" ->
    AffineChannelNorm."""
    check_norm(norm)
    if norm == "affine":
        return AffineChannelNorm(channels)
    return group_norm(groups, channels)


def norm_name(norm: str, index: int) -> str:
    """The name flax gives the index-th unnamed norm layer of a module."""
    kind = "AffineChannelNorm" if norm == "affine" else "GroupNorm"
    return f"{kind}_{index}"
