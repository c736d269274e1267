"""Plain versions of the port's hand-written kernels, frozen here as the
reference computes them: K1's kNN mean distance and K3's exact NMS (the
rank predicate's fixpoint on unsorted boxes).  K2's plain version is
`pose/extraction.py:grid_extract`."""

from __future__ import annotations

import torch


def knn_mean_dists(points: torch.Tensor, valid: torch.Tensor,
                   cols: torch.Tensor, k: int) -> torch.Tensor:
    """points (B, N, 3) f32, valid (B, N) bool, cols (C,) candidate indices
    into N, k -> (B, N): for each valid point the mean of sqrt(d2) to its k
    nearest valid, non-self candidates, d2 = max(|p|^2 + |q|^2 - 2 p.q, 0);
    0 for an invalid point."""
    cols = cols.long()
    n = points.shape[1]
    px, py, pz = points.unbind(-1)
    qx, qy, qz = points[:, cols].unbind(-1)
    sq_r = px * px + py * py + pz * pz
    sq_c = qx * qx + qy * qy + qz * qz
    cross = (px[:, :, None] * qx[:, None, :] + py[:, :, None] * qy[:, None, :]
             + pz[:, :, None] * qz[:, None, :])
    d2 = torch.clamp(sq_r[:, :, None] + sq_c[:, None, :] - 2.0 * cross,
                     min=0.0)
    self_col = (torch.arange(n, device=points.device)[:, None]
                == cols[None, :])
    ok = valid[:, cols][:, None, :] & ~self_col[None]
    d2 = torch.where(ok, d2, torch.full_like(d2, torch.inf))
    vals = torch.topk(d2, k, dim=-1, largest=False, sorted=True).values
    finite = torch.isfinite(vals)
    roots = torch.sqrt(vals)
    acc = torch.zeros_like(sq_r)
    for t in range(k):
        acc = acc + torch.where(finite[..., t], roots[..., t],
                                torch.zeros_like(acc))
    mean = acc / torch.clamp(finite.sum(-1), min=1)
    return torch.where(valid, mean, torch.zeros_like(mean))


def fixpoint_keep(valid: torch.Tensor, suppress: torch.Tensor
                  ) -> torch.Tensor:
    """The unique fixpoint of ``keep <- valid & ~any(keep & suppress)``,
    iterated from ``keep = valid``: valid (..., K), suppress (..., K, K)
    with suppress[i, j] only where i ranks above j."""
    keep = valid
    for _ in range(valid.shape[-1] + 1):
        new = valid & ~(keep[..., :, None] & suppress).any(-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep
