"""Box-grid pose point extraction (counterpart of
`mot3d_tpu/pose/extraction.py:grid_extract`), batched over detection slots.

For each slot, sample a fixed G x G grid of pixel positions inside the
detection box and evaluate everything only there:
  - depth and in-range flags at the covering pixel floor(pos), clipped;
  - the 28 x 28 NOCS patch and mask probabilities, through the aligned
    bilinear weights of `_patch_bilinear` (cell centres at
    lo + (j + 0.5) / P * (hi - lo)), which have at most two non-zero taps
    per axis — so the sampling is written as those taps;
  - backprojection at the integer pixel, y and z negated (reference
    `PoseEst/pose_estimation.py:16-43`).

This is the default "grid" extraction and the plain version of the K2
kernel (`ops/cuda/pose_extract.py`): the two evaluate the same expressions
in the same order, so on one device they agree bit for bit.
"""

from __future__ import annotations

import torch


def _sample_axis(lo: torch.Tensor, hi: torch.Tensor, g: int, size: int,
                 p: int):
    """Per slot (lo, hi (S,)): covering pixels (S, g) clipped into
    [0, size), their in-range flags, and the two patch taps (j0, j1) with
    their normalised bilinear weights (w0, w1)."""
    gi = torch.arange(g, dtype=lo.dtype, device=lo.device)
    # A tensor divisor: PyTorch turns division by a Python scalar into a
    # multiplication by its reciprocal on the GPU, which rounds differently
    # from the kernel's true division.
    g_div = torch.full((), float(g), dtype=lo.dtype, device=lo.device)
    pos = lo[:, None] + (gi + 0.5) / g_div * (hi - lo)[:, None]
    idx = torch.floor(pos).long()
    ok = (idx >= 0) & (idx < size)
    idx = torch.clamp(idx, 0, size - 1)
    den = torch.clamp(hi - lo, min=1e-6)[:, None]
    f = (idx.float() + 0.5 - lo[:, None]) / den * p - 0.5
    f = torch.clamp(f, 0.0, p - 1.0)
    j0 = torch.floor(f)
    w0 = torch.clamp(1.0 - torch.abs(f - j0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(f - (j0 + 1.0)), min=0.0)
    norm = torch.clamp(w0 + w1, min=1e-6)
    j0 = j0.long()
    return idx, ok, j0, torch.clamp(j0 + 1, max=p - 1), w0 / norm, w1 / norm


def grid_extract(nocs: torch.Tensor, masks: torch.Tensor,
                 boxes: torch.Tensor, depth: torch.Tensor,
                 intrinsics: torch.Tensor, grid: int = 32,
                 mask_thresh: float = 0.5):
    """Slots -> ((S, grid*grid, 6) [cam xyz | nocs rgb], (S, grid*grid)
    valid).

    nocs (S, P, P, 3); masks (S, P, P) box-space mask probabilities; boxes
    (S, 4) XYXY image coords; depth (H, W) shared by every slot, or
    (F, H, W) with S a multiple of F, slot s reading frame s // (S // F).
    """
    s, p = nocs.shape[0], nocs.shape[1]
    if depth.dim() == 2:
        depth = depth[None]
    f_count, h, w = depth.shape
    frame = torch.arange(s, device=nocs.device) // max(s // f_count, 1)
    vy, ok_v, y0, y1, wy0, wy1 = _sample_axis(boxes[:, 1], boxes[:, 3],
                                              grid, h, p)
    ux, ok_u, x0, x1, wx0, wx1 = _sample_axis(boxes[:, 0], boxes[:, 2],
                                              grid, w, p)
    si = torch.arange(s, device=nocs.device)[:, None, None]
    r0, r1 = y0[:, :, None], y1[:, :, None]
    c0, c1 = x0[:, None, :], x1[:, None, :]
    a0, a1 = wy0[:, :, None], wy1[:, :, None]
    b0, b1 = wx0[:, None, :], wx1[:, None, :]

    d = depth[frame[:, None, None], vy[:, :, None], ux[:, None, :]]
    m = (a0 * (b0 * masks[si, r0, c0] + b1 * masks[si, r0, c1])
         + a1 * (b0 * masks[si, r1, c0] + b1 * masks[si, r1, c1]))
    a0, a1, b0, b1 = (t[..., None] for t in (a0, a1, b0, b1))
    n = (a0 * (b0 * nocs[si, r0, c0] + b1 * nocs[si, r0, c1])
         + a1 * (b0 * nocs[si, r1, c0] + b1 * nocs[si, r1, c1]))
    valid = ((d > 0) & (m >= mask_thresh)
             & ok_v[:, :, None] & ok_u[:, None, :])

    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (ux[:, None, :].float() - cx) / fx * d
    y = (vy[:, :, None].float() - cy) / fy * d
    pts = torch.stack([x, -y, -d], dim=-1)
    feats = torch.cat([pts, n], dim=-1).reshape(s, grid * grid, 6)
    valid = valid.reshape(s, grid * grid)
    return torch.where(valid[..., None], feats, torch.zeros_like(feats)), valid
