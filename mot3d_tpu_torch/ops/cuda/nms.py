"""K3: exact greedy NMS, every problem of a batch in one call.

Replaces the TPU kernel `mot3d_tpu/ops/pallas/nms_kernel.py:
pallas_nms_sorted` and its wrapper `pallas_nms_mask`.  On score-sorted XYXY
boxes with a validity flag, box i is kept iff it is valid and no kept box
of a higher rank has IoU > thresh with it.

On the H100 the pair work is bound by operations (about 14 fp32 operations
per valid pair against 18 bytes per box), but one problem's floor is the
serial chain over its ranks.  `csrc/nms.cu` runs two kernels per call:
the first builds the 64-bit suppression words (one word per thread, several
blocks per problem) into a scratch mask of K * ceil(K / 64) words per
problem; the second copies a problem's mask into shared memory and lets
one warp walk the ranks with the removed words in registers.  The (K, K)
float IoU matrix the plain version materialises never exists.

`exact_nms_mask` is the drop-in for unsorted boxes: a stable descending
sort by score with invalid boxes last (the order of the sort-free predicate
in `ops/nms.py`), the scan, and the unsort.  `nms_sorted` launches the
kernel for a CUDA tensor and takes the plain version, `nms_sorted_plain`
(the fixpoint iteration), only for a CPU tensor.
"""

from __future__ import annotations

from typing import Callable

import torch

from mot3d_tpu_torch.geometry.iou3d import box2d_iou_matrix
from mot3d_tpu_torch.ops.cuda.build import LaunchCounter, check, library

launches = LaunchCounter()

# Two 64-bit removed words per lane of the scanning warp.  Up to K = 1344
# the scan holds a problem's mask in shared memory; above, it reads the
# scratch mask in global memory.
MAX_K = 4096


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


def nms_sorted_plain(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version: boxes (..., K, 4) in rank order, valid
    (..., K) bool -> keep (..., K) bool."""
    idx = torch.arange(boxes.shape[-2], device=boxes.device)
    suppress = ((box2d_iou_matrix(boxes, boxes) > iou_threshold)
                & (idx[:, None] < idx[None, :])
                & valid[..., :, None] & valid[..., None, :])
    return fixpoint_keep(valid, suppress)


def nms_sorted(boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """Keep mask of score-sorted boxes.

    boxes (..., K, 4) f32 XYXY, finite, contiguous, rank order along K;
    valid (..., K) bool; K <= 4096.  Every leading dimension is an
    independent problem; one call (the pair kernel, then the scan kernel)
    covers them all.  Returns (..., K) bool."""
    if boxes.device.type == "cpu":
        return nms_sorted_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_sorted: unsupported device {boxes.device}")
    if boxes.dim() < 2 or boxes.shape[-1] != 4 \
            or valid.shape != boxes.shape[:-1]:
        raise ValueError(f"need boxes (..., K, 4) and valid (..., K), got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("nms_sorted expects float32 boxes and bool valid, "
                        f"got {boxes.dtype} and {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError("boxes and valid must be on one device")
    if not (boxes.is_contiguous() and valid.is_contiguous()) \
            or boxes.data_ptr() % 16:
        raise ValueError("nms_sorted expects contiguous, 16-byte aligned "
                         "tensors")
    k = boxes.shape[-2]
    q = valid.numel() // max(k, 1)
    if k > MAX_K:
        raise ValueError(f"need K <= {MAX_K}, got K={k}")
    keep = torch.empty_like(valid)
    with torch.cuda.device(boxes.device):
        lib = library()
        mask = torch.empty(q * lib.mot3d_nms_scratch_words(k),
                           dtype=torch.int64, device=boxes.device)
        err = lib.mot3d_nms_sorted(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            mask.data_ptr(), q, k, float(iou_threshold),
            torch.cuda.current_stream().cuda_stream)
    check(err, "nms_sorted")
    launches.count += 1
    return keep


def exact_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, iou_threshold: float,
                   scan: Callable = nms_sorted) -> torch.Tensor:
    """Exact NMS keep mask (..., K) of unsorted boxes (..., K, 4): sort,
    `scan` the sorted boxes, unsort.  The stable descending sort puts equal
    scores in index order and invalid boxes (score -inf) last."""
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    keep_s = scan(boxes_s, torch.gather(valid, -1, order), iou_threshold)
    return torch.zeros_like(valid).scatter(-1, order, keep_s)
