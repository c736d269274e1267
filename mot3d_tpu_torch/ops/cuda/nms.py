"""K3: exact greedy NMS, every problem of a call in one launch.

Replaces the TPU kernel `mot3d_tpu/ops/pallas/nms_kernel.py:
pallas_nms_sorted` and its wrapper `pallas_nms_mask`.  On unsorted XYXY
boxes with a score and a validity flag, box i is kept iff it is valid and
no kept box ranked above it has IoU > thresh with it; the rank is the order
of a stable descending sort of where(valid, score, -inf), the order of the
sort-free predicate in `ops/nms.py`.

On the H100 the pair work is bound by operations (about 14 fp32 operations
per valid pair against 22 bytes per box); in practice a call is bound by
instruction issue in the pair tests and, per problem, by the latency of the
sort and of the serial scan.  `csrc/nms.cu` computes `pallas_nms_mask`
whole in one kernel: one thread-block cluster per problem (1-8 blocks,
`last_cluster`) sorts the problem in shared memory, builds the triangular
mask of 64-bit suppression words spread over the cluster's shared memory,
and scans it 64 ranks at a time from block 0 through distributed shared
memory; the kept mask comes back in the input order.  No scratch in device
memory, no sort or gather around the kernel, strided inputs taken as they
are (`launch_layout`).

`exact_nms_mask` launches the kernel for a CUDA tensor and takes the plain
version, `exact_nms_mask_plain` (stable sort, the fixpoint iteration
`nms_sorted_plain` on the sorted boxes, unsort), only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from mot3d_tpu_torch.geometry.iou3d import box2d_iou_matrix
from mot3d_tpu_torch.ops.cuda.build import LaunchCounter, check, library

launches = LaunchCounter()
# Blocks per problem (the cluster size) of the last launch, for reports.
last_cluster = 0

# Triangular storage lets a cluster of 8 blocks hold the mask up to here.
MAX_K = 4096
# Leading dimensions the kernel takes (after merging those that can be).
MAX_LEAD = 4


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
    """Keep mask of score-sorted boxes: boxes (..., K, 4) in rank order,
    valid (..., K) bool -> keep (..., K) bool."""
    idx = torch.arange(boxes.shape[-2], device=boxes.device)
    suppress = ((box2d_iou_matrix(boxes, boxes) > iou_threshold)
                & (idx[:, None] < idx[None, :])
                & valid[..., :, None] & valid[..., None, :])
    return fixpoint_keep(valid, suppress)


def exact_nms_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                         valid: torch.Tensor, iou_threshold: float,
                         scan: Callable = nms_sorted_plain) -> torch.Tensor:
    """Plain PyTorch version of `exact_nms_mask`: sort, `scan` the sorted
    boxes, unsort.  The stable descending sort puts equal scores in index
    order and invalid boxes (score -inf) last."""
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    keep_s = scan(boxes_s, torch.gather(valid, -1, order), iou_threshold)
    return torch.zeros_like(valid).scatter(-1, order, keep_s)


def launch_layout(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, keep: torch.Tensor) -> list:
    """The kernel's `Layout` as 25 ints: the MAX_LEAD leading sizes, then
    the element strides of boxes (leading, K, coordinate), scores, valid
    and keep (leading, K).  Leading dimensions are merged where all four
    tensors allow it and padded in front with size 1, stride 0."""
    tensors = (boxes, scores, valid, keep)
    lead = tuple(valid.shape[:-1])
    dims = []
    for d, n in enumerate(lead):
        if n == 1:
            continue
        st = [t.stride(d) for t in tensors]
        if dims and all(p == s * n for p, s in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > MAX_LEAD:
        raise ValueError(f"exact_nms_mask: leading dimensions {lead} with "
                         f"these strides do not merge into {MAX_LEAD}")
    dims = [(1, [0] * 4)] * (MAX_LEAD - len(dims)) + dims
    layout = [n for n, _ in dims]
    for i, tail in enumerate(((-2, -1), (-1,), (-1,), (-1,))):
        layout += [st[i] for _, st in dims] + [tensors[i].stride(d)
                                               for d in tail]
    return layout


def exact_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact NMS keep mask (..., K) of unsorted boxes.

    boxes (..., K, 4) f32 XYXY, finite; scores (..., K) f32, finite; valid
    (..., K) bool; K <= 4096; any strides.  Every leading index is an
    independent problem; one launch covers them all.  Returns (..., K)
    bool laid out like `valid`."""
    if boxes.device.type == "cpu":
        return exact_nms_mask_plain(boxes, scores, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"exact_nms_mask: unsupported device {boxes.device}")
    if boxes.dim() < 2 or boxes.shape[-1] != 4 \
            or valid.shape != boxes.shape[:-1] or scores.shape != valid.shape:
        raise ValueError("need boxes (..., K, 4), scores and valid (..., K), "
                         f"got {tuple(boxes.shape)}, {tuple(scores.shape)} "
                         f"and {tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 \
            or valid.dtype != torch.bool:
        raise TypeError("exact_nms_mask expects float32 boxes and scores and "
                        f"bool valid, got {boxes.dtype}, {scores.dtype} and "
                        f"{valid.dtype}")
    if scores.device != boxes.device or valid.device != boxes.device:
        raise ValueError("boxes, scores and valid must be on one device")
    k = boxes.shape[-2]
    if k > MAX_K:
        raise ValueError(f"need K <= {MAX_K}, got K={k}")
    keep = torch.empty_like(valid)
    if keep.numel() == 0:
        return keep
    global last_cluster
    layout = launch_layout(boxes, scores, valid, keep)
    cluster = ctypes.c_int(0)
    with torch.cuda.device(boxes.device):
        err = library().mot3d_nms_mask(
            boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
            keep.data_ptr(), (ctypes.c_longlong * len(layout))(*layout), k,
            float(iou_threshold), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(cluster))
    check(err, "nms_mask")
    launches.count += 1
    last_cluster = cluster.value
    return keep
