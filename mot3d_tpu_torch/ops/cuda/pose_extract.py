"""K2: fused pose point extraction for every detection slot of a sequence.

Replaces the TPU kernel `mot3d_tpu/ops/pallas/pose_extract.py:
pose_extract_pallas`, which ran one frame per call with the depth map held
in VMEM.  Here one launch covers all T * I slots of a sequence: depth is
(T, H, W) and slot s reads frame s // I.

On the H100 the work is bound by bytes: the NOCS and mask patches, the
depth samples and the (S, G*G, 6) output, at about three fp32 operations
per byte.  The CUDA kernel (`csrc/pose_extract.cu`) stages each slot's
patches in shared memory, reads its G*G depth samples from global memory (a
240 x 320 frame does not fit a block's shared memory), and evaluates the at
most 2 x 2 non-zero bilinear taps per sample instead of the plain version's
gathers of whole tensors.

`pose_extract` launches the kernel for a CUDA tensor and takes the plain
version, `pose/extraction.py:grid_extract`, only for a CPU tensor.
"""

from __future__ import annotations

import torch

from mot3d_tpu_torch.ops.cuda.build import LaunchCounter, check, library
from mot3d_tpu_torch.pose.extraction import grid_extract

launches = LaunchCounter()

MAX_PATCH = 48  # 36 KB of shared memory per block


def pose_extract(nocs: torch.Tensor, masks: torch.Tensor,
                 boxes: torch.Tensor, depth: torch.Tensor,
                 intrinsics: torch.Tensor, grid: int = 32,
                 mask_thresh: float = 0.5):
    """All slots -> ((S, grid*grid, 6) feats, (S, grid*grid) bool valid).

    nocs (S, P, P, 3); masks (S, P, P) probabilities; boxes (S, 4) XYXY;
    depth (F, H, W) with S a multiple of F (slot s reads frame
    s // (S // F)); intrinsics (3, 3).  All float32.  Same contract as
    `grid_extract`."""
    if nocs.device.type == "cpu":
        return grid_extract(nocs, masks, boxes, depth, intrinsics, grid,
                            mask_thresh)
    if nocs.device.type != "cuda":
        raise ValueError(f"pose_extract: unsupported device {nocs.device}")
    s, p = nocs.shape[0], nocs.shape[1]
    if depth.dim() == 2:
        depth = depth[None]
    f, h, w = depth.shape
    tensors = (nocs, masks, boxes, depth, intrinsics)
    if tuple(nocs.shape[1:]) != (p, p, 3) or tuple(masks.shape) != (s, p, p) \
            or tuple(boxes.shape) != (s, 4) \
            or tuple(intrinsics.shape) != (3, 3):
        raise ValueError("pose_extract expects nocs (S, P, P, 3), masks "
                         "(S, P, P), boxes (S, 4), intrinsics (3, 3)")
    if f == 0 or s % f:
        raise ValueError(f"{s} slots do not split over {f} depth frames")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("pose_extract expects float32 tensors")
    if any(t.device != nocs.device for t in tensors):
        raise ValueError("pose_extract inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pose_extract expects contiguous tensors")
    if not 1 <= p <= MAX_PATCH or grid < 1:
        raise ValueError(f"need 1 <= P <= {MAX_PATCH} and grid >= 1")
    feats = torch.empty((s, grid * grid, 6), dtype=torch.float32,
                        device=nocs.device)
    valid = torch.empty((s, grid * grid), dtype=torch.bool,
                        device=nocs.device)
    with torch.cuda.device(nocs.device):
        err = library().mot3d_pose_extract(
            nocs.data_ptr(), masks.data_ptr(), boxes.data_ptr(),
            depth.data_ptr(), intrinsics.data_ptr(), feats.data_ptr(),
            valid.data_ptr(), s, s // f, p, grid, h, w, float(mask_thresh),
            torch.cuda.current_stream().cuda_stream)
    check(err, "pose_extract")
    launches.count += 1
    return feats, valid
