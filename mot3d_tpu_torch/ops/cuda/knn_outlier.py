"""K1: fused kNN mean-distance for statistical outlier removal.

Replaces the TPU kernel `mot3d_tpu/ops/pallas/knn_outlier.py:
knn_mean_dists_pallas`.  For each valid point, the mean of sqrt(d2) to its
k nearest valid, non-self candidates, d2 = max(|p|^2 + |q|^2 - 2 p.q, 0);
invalid points get 0.

On the H100 the work is bound by the min/max pipe (half the fp32 rate):
keeping the k smallest distances costs 2k - 1 min/max per valid
point-candidate pair beside 8 fp32 operations for d2, and the bytes (17 per
point) do not count.  The CUDA kernel (`csrc/knn_outlier.cu`) therefore
spends min/max on valid pairs only and nothing else per pair: each block
compacts the detection's valid candidates and 128 of its valid points into
shared memory (invalid points get 0 without pair work), each thread keeps
one point's top-k sorted in registers with a depth-2 insertion, the top-k
width is a template instance (exact for k = 5 and 20), a distance that is
not below the current k-th skips the insertion at k > 8, and the self test
runs only where the warp's own points sit among the candidates.  The
(B, N, C) distance matrix the plain version materialises never exists.

`knn_mean_dists` launches the kernel for a CUDA tensor and takes the plain
version, `knn_mean_dists_plain`, only for a CPU tensor.
"""

from __future__ import annotations

import torch

from mot3d_tpu_torch.ops.cuda.build import LaunchCounter, check, library

launches = LaunchCounter()

MAX_K = 32
MAX_CANDIDATES = 2048  # 44 KB of shared memory per block, under 48 KB

# The kernel's compiled top-k widths, as `csrc/knn_outlier.cu:
# mot3d_knn_mean_dists` dispatches them: k = 5 and k = 20 are the default
# configuration's subset and full modes.
KSLOTS = (5, 8, 16, 20, 32)
THREADS = 128  # points per block, one per thread (kThreads)


def kslots_for(k: int) -> int:
    """The narrowest compiled top-k width with at least k slots."""
    return next(w for w in KSLOTS if w >= k)


def smem_bytes(c: int) -> int:
    """Dynamic shared memory of one block for C candidates, as
    `csrc/knn_outlier.cu:smem_bytes` lays it out: the candidates and the
    block's points (float4 + int32 index each), the points' self ranges
    (two int32 each)."""
    return (c + THREADS) * (16 + 4) + 2 * THREADS * 4


def knn_mean_dists_plain(points: torch.Tensor, valid: torch.Tensor,
                         cols: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: points (B, N, 3) f32, valid (B, N) bool,
    cols (C,) candidate indices into N, k -> (B, N) f32.

    d2 uses the kernel's expanded formula with the same order of separate
    multiplies and adds; masked columns are +inf, `topk` takes the k
    smallest, and the finite roots are summed in ascending order.  Invalid
    points give 0, as in the kernel: the outlier threshold
    (`geometry/outlier.py:_threshold_keep`) never reads them, so the two
    agree on every row."""
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


def knn_mean_dists(points: torch.Tensor, valid: torch.Tensor,
                   cols: torch.Tensor, k: int) -> torch.Tensor:
    """Mean distance to the k nearest candidates, per valid point; 0 for an
    invalid point.

    points (B, N, 3) f32 contiguous; valid (B, N) bool; cols (C,) int32
    source index of each candidate (shared by all B); 1 <= k <= 32.
    Returns (B, N) f32.  Forward only."""
    if points.device.type == "cpu":
        return knn_mean_dists_plain(points, valid, cols, k)
    if points.device.type != "cuda":
        raise ValueError(f"knn_mean_dists: unsupported device "
                         f"{points.device}")
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    b, n, _ = points.shape
    c = cols.shape[0]
    if points.dtype != torch.float32 or valid.dtype != torch.bool \
            or cols.dtype != torch.int32:
        raise TypeError("knn_mean_dists expects float32 points, bool valid "
                        "and int32 cols")
    if tuple(valid.shape) != (b, n) or cols.dim() != 1:
        raise ValueError("valid must be (B, N) and cols (C,)")
    if not (valid.device == cols.device == points.device):
        raise ValueError("points, valid and cols must be on one device")
    if not (points.is_contiguous() and valid.is_contiguous()
            and cols.is_contiguous()):
        raise ValueError("knn_mean_dists expects contiguous tensors")
    if not 1 <= k <= MAX_K or not 1 <= c <= MAX_CANDIDATES:
        raise ValueError(f"need 1 <= k <= {MAX_K} and 1 <= C <= "
                         f"{MAX_CANDIDATES}, got k={k}, C={c}")
    out = torch.empty((b, n), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        err = library().mot3d_knn_mean_dists(
            points.data_ptr(), valid.data_ptr(), cols.data_ptr(),
            out.data_ptr(), b, n, c, k, kslots_for(k),
            torch.cuda.current_stream().cuda_stream)
    check(err, "knn_mean_dists")
    launches.count += 1
    return out
