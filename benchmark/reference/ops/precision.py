"""Matmul-precision control (counterpart of `mot3d_tpu/ops/precision.py`).

On the GPU, cuDNN convolutions default to TF32 (about three decimal digits)
and matmuls may be switched to it; the geometry core (pose solving,
covariances, pairwise distances) needs true float32.  `strict_fp32()` turns
TF32 off for both `torch.backends.cuda.matmul` and `torch.backends.cudnn`
for its extent, as a context (`with strict_fp32():`) or a decorator
(`@strict_fp32()`), and restores the previous settings on exit.
"""

from __future__ import annotations

import contextlib

import torch


# The control of the benchmark's comparison sets this: the geometry then
# runs in TF32, the precision below the true float32 it states.
TF32 = False


@contextlib.contextmanager
def strict_fp32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = TF32
    torch.backends.cudnn.allow_tf32 = TF32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
