"""K2: fused pose point extraction for every detection slot of a sequence.

Replaces the TPU kernel `mot3d_tpu/ops/pallas/pose_extract.py:
pose_extract_pallas`, which ran one frame per call with the depth map held
in VMEM.  Here one launch covers all T * I slots of a sequence: depth is
(T, H, W) and slot s reads frame s // I.

On the H100 the work is bound by latency, not by bandwidth: a slot moves
~38 KB (patches, depth samples, the (G*G, 6) output), the whole call of a
sequence ~23 MB, but each slot's samples wait on a patch copy and on depth
gathers that depend on the box.  The CUDA kernel (`csrc/pose_extract.cu`)
gives each slot a block that stages its patches with bulk copies (TMA) on
an mbarrier, or per thread where P is odd or a pointer is not 16-byte
aligned; computes the G row and G column axes (pixel, taps, weights) once
into shared memory while the copy runs; issues all its depth gathers before
it waits on anything (a 240 x 320 frame does not fit a block's shared
memory); and stages the samples' outputs in shared memory so that they
leave as coalesced 16-byte stores.  It evaluates the at most 2 x 2 non-zero
bilinear taps per sample instead of the plain version's gathers of whole
tensors.

`pose_extract` launches the kernel for a CUDA tensor and takes the plain
version, `pose/extraction.py:grid_extract`, only for a CPU tensor.  Either
runs inside `ForwardOnly`, an autograd function whose backward raises: the
kernel writes its outputs through raw pointers, so a gradient through it
would otherwise be a silent zero.  The JAX package cannot differentiate its
Pallas kernel either (`jax.grad` fails to linearise it), and the port's
train steps refuse `pose.extraction="pallas"` when they are built.
"""

from __future__ import annotations

import torch

from mot3d_tpu_torch.ops.cuda.build import LaunchCounter, check, library
from mot3d_tpu_torch.pose.extraction import grid_extract

launches = LaunchCounter()

MAX_PATCH = 48
SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use
SAMPLES_PER_ROUND = 1024    # staged in shared memory per round (kChunk)


def smem_bytes(p: int, grid: int) -> int:
    """Dynamic shared memory of one block, as `csrc/pose_extract.cu:
    smem_bytes` lays it out: mbarrier (16), NOCS and mask patch (16 P^2),
    the two axis tables (2 G x 24 bytes), one round's staged feats and
    valid bytes (25 per sample)."""
    return 16 + 16 * p * p + 48 * grid + 25 * SAMPLES_PER_ROUND


NO_GRADIENT = (
    "pose_extract (the K2 kernel, pose.extraction='pallas') has no "
    "gradient: the JAX package cannot differentiate its Pallas kernel "
    "either.  Train with pose.extraction='grid'; a backward for the kernel "
    "is ROADMAP.md Queue 1, item 'K2 backward'")


class ForwardOnly(torch.autograd.Function):
    """Runs `impl(*args)` -> (feats, valid) without recording its inside;
    backward raises instead of returning a zero gradient."""

    @staticmethod
    def forward(ctx, impl, *args):
        feats, valid = impl(*args)
        ctx.mark_non_differentiable(valid)
        return feats, valid

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(NO_GRADIENT)


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
        return ForwardOnly.apply(grid_extract, nocs, masks, boxes, depth,
                                 intrinsics, grid, mask_thresh)
    if nocs.device.type != "cuda":
        raise ValueError(f"pose_extract: unsupported device {nocs.device}")
    return ForwardOnly.apply(_launch, nocs, masks, boxes, depth, intrinsics,
                             grid, mask_thresh)


def _launch(nocs, masks, boxes, depth, intrinsics, grid, mask_thresh):
    """The K2 launch on CUDA tensors, after checking the contract."""
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
    if not 1 <= p <= MAX_PATCH or grid < 1 \
            or smem_bytes(p, grid) > SMEM_LIMIT:
        raise ValueError(f"need 1 <= P <= {MAX_PATCH} and a grid whose "
                         f"axis tables fit shared memory, got P={p}, "
                         f"grid={grid}")
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
