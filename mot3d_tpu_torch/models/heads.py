"""Transposed convolution with flax's SAME padding, shared by the mask, voxel
and NOCS heads.

flax's `ConvTranspose(padding="SAME")` (with `transpose_kernel=False`)
dilates the input by the stride, pads it by (pad_a, pad_b) from
`lax._conv_transpose_padding` and correlates with the kernel as stored.
torch's transposed convolution pads by k - 1 - padding on the left (plus
output_padding on the right) and correlates with the spatially flipped
kernel; `importers/flax_params.py` flips the kernel, and the padding is
chosen here so both give the same output size and alignment.
"""

from __future__ import annotations

import math

from torch import nn


def same_transpose_padding(k: int, s: int):
    """(padding, output_padding) of torch's transposed convolution that
    reproduce flax's SAME transposed convolution for kernel k, stride s."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    pad_b = pad_len - pad_a
    padding, output_padding = k - 1 - pad_a, pad_b - pad_a
    if padding < 0 or not 0 <= output_padding < s:
        raise ValueError(f"no torch padding matches flax SAME for k={k}, "
                         f"s={s}")
    return padding, output_padding


def conv_transpose(dims: int, in_ch: int, out_ch: int, k: int,
                   stride: int = 1) -> nn.Module:
    padding, output_padding = same_transpose_padding(k, stride)
    cls = nn.ConvTranspose2d if dims == 2 else nn.ConvTranspose3d
    return cls(in_ch, out_ch, k, stride=stride, padding=padding,
               output_padding=output_padding)
