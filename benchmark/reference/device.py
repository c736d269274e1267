"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU.  Without one this raises: an entry point never
    falls back to the CPU on its own; pass `device="cpu"` to run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mot3d_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
