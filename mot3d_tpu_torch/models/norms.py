"""Normalisation layers for the detection model (counterpart of
`mot3d_tpu/models/norms.py`).

Only the default "gn" mode is ported: GroupNorm over contiguous channel
groups, with flax's epsilon of 1e-6 (torch's default is 1e-5).  The
"affine" mode (folded frozen BatchNorm, used for imported reference
checkpoints) raises `NotImplementedError`.
"""

from __future__ import annotations

from torch import nn

GN_EPS = 1e-6


def check_norm(norm: str) -> None:
    if norm == "affine":
        raise NotImplementedError(
            "detection.norm='affine' (the torch-checkpoint import mode) is "
            "not ported yet: ROADMAP.md Queue 1, item 'Detector import "
            "mode'")
    if norm != "gn":
        raise ValueError(f"unknown norm {norm!r} (expected 'gn' or 'affine')")


def group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=GN_EPS)
