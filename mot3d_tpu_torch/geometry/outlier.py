"""Statistical outlier removal (counterpart of
`mot3d_tpu/geometry/outlier.py`).

Replacement for open3d's `remove_statistical_outlier` (reference use at
`PoseEst/pose_estimation.py:311-349`): for each point, the mean distance to
its k nearest neighbours; points whose mean exceeds mean + std_ratio * std
(sample std over valid points) are dropped.  The k-NN is exact: a CUDA
tensor goes to the K1 kernel (`ops/cuda/knn_outlier.py`), a CPU tensor to
its plain PyTorch version.
"""

from __future__ import annotations

import torch

from mot3d_tpu_torch.ops.cuda.knn_outlier import knn_mean_dists
from mot3d_tpu_torch.ops.precision import strict_fp32


def candidate_columns(n: int, candidates: int, nb_neighbors: int,
                      device=None):
    """(cols (C,) int32, k) of the neighbour search.  candidates > 0 picks
    an evenly spread subset (the centre of each of `candidates` equal spans
    of [0, n)) and scales `nb_neighbors` by the same fraction."""
    if candidates and candidates < n:
        cols = (torch.arange(candidates, device=device) * n + n // 2) \
            // candidates
        k = max(1, round(nb_neighbors * candidates / n))
    else:
        cols = torch.arange(n, device=device)
        k = nb_neighbors
    return cols.to(torch.int32), min(k, cols.shape[0] - 1)


@strict_fp32()
def statistical_outlier_mask(points: torch.Tensor, valid: torch.Tensor,
                             nb_neighbors: int = 20, std_ratio: float = 2.0,
                             min_points: int = 100,
                             candidates: int = 0) -> torch.Tensor:
    """Kept-point mask (..., N) for padded point buffers (..., N, 3).

    open3d semantics: threshold = mean + std_ratio * sample-std of the
    per-point mean kNN distances.  A buffer with fewer than `min_points`
    valid points keeps its input mask (the reference skips cleaning below
    100 points).  The mask is a non-differentiable selection: the points are
    detached before the kernel."""
    n = points.shape[-2]
    lead = points.shape[:-2]
    pts = points.detach().reshape(-1, n, 3).contiguous()
    val = valid.reshape(-1, n).bool().contiguous()
    cols, k = candidate_columns(n, candidates, nb_neighbors, points.device)
    mean_knn = knn_mean_dists(pts, val, cols, k)
    return _threshold_keep(mean_knn, val, std_ratio, min_points).reshape(
        lead + (n,))


def _threshold_keep(mean_knn: torch.Tensor, valid: torch.Tensor,
                    std_ratio: float, min_points: int) -> torch.Tensor:
    """open3d rule per row of (B, N): drop points whose mean-kNN distance
    exceeds mean + std_ratio * sample-std over the valid points."""
    zeros = torch.zeros_like(mean_knn)
    count = valid.sum(-1, keepdim=True)
    n_valid = torch.clamp(count, min=1)
    mu = torch.where(valid, mean_knn, zeros).sum(-1, keepdim=True) / n_valid
    var = (torch.where(valid, (mean_knn - mu) ** 2, zeros).sum(-1, keepdim=True)
           / torch.clamp(n_valid - 1, min=1))
    thresh = mu + std_ratio * torch.sqrt(var)
    keep = valid & (mean_knn <= thresh)
    return torch.where(count < min_points, valid, keep)
