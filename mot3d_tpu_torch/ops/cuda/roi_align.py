"""Gather ROIAlign: every box of a call pooled over the FPN pyramid in one
launch, and its gradient.

Replaces no TPU kernel: the JAX package pools with two einsums of one-hot
weights against the packed pyramid, and so does the plain version,
`ops/roi_align.py:multilevel_roi_align_batched_packed`, one frame at a time.
On the H100 that is ~17 GFLOP of zero terms, a 287 MB intermediate and
~150 launches per frame at the serving shapes.  `csrc/roi_align.cu` computes
the same ROIAlignV2 from each bin's at most 4 x 4 bilinear taps with the
plain version's combined per-axis weights.

What bounds it: bytes (the box pooler at the serving shapes writes 627 MB
and reads at most 174 MB of maps: 0.24 ms at 3.35 TB/s).  The design: one
block per (box, output row) over the whole (B, N) batch, channels on lanes
with 16-byte loads and stores from channels-last maps (`forward` copies
them, one read and one write of the maps a call), the taps of a row in
shared memory, no scratch.  The level of each box is the caller's:
`assign_fpn_level` once over the whole batch.

`ops/roi_align.py:roi_align_pyramid` calls `forward` and `backward` for
CUDA tensors, inside its autograd function.  The backward adds every bin's
gradient into zeroed float64 level gradients (and the box gradients) by
atomicAdd, in no fixed order, and rounds them to float32 after the launch.
Each addend is a float32 number, so a float64 sum is exact, and the same in
any order, while the absolute addends of one sum add up to less than 2**29
times the smallest non-zero one; past that its last bits, and in rare cases
its float32 rounding, can change from run to run.
"""

from __future__ import annotations

import ctypes
import warnings

import torch

from mot3d_tpu_torch.ops.cuda.build import LaunchCounter, check, library

launches = LaunchCounter()
backward_launches = LaunchCounter()

# As `csrc/roi_align.cu` compiles them (kMaxLevels, kMaxSampling, kMaxOut).
MAX_LEVELS = 4
MAX_SAMPLING = 2
MAX_OUTPUT = 32


def _check(maps, boxes, output_size, strides, sampling_ratio) -> None:
    if boxes.dtype != torch.float32 or any(m.dtype != torch.float32
                                           for m in maps):
        raise TypeError("roi_align_pyramid expects float32 maps and boxes")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, N, 4), got "
                         f"{tuple(boxes.shape)}")
    b, n = boxes.shape[:2]
    if not 1 <= len(maps) <= MAX_LEVELS or len(strides) != len(maps):
        raise ValueError(f"need 1 to {MAX_LEVELS} maps, one stride each")
    c = maps[0].shape[1]
    for m in maps:
        if m.dim() != 4 or m.shape[0] != b or m.shape[1] != c:
            raise ValueError(f"maps must be (B={b}, C, H, W) with one C, "
                             f"got {tuple(m.shape)}")
        if m.device != boxes.device:
            raise ValueError("maps and boxes must be on one device")
        if m.data_ptr() % 16:
            raise ValueError("maps must start on a 16-byte boundary")
    if c % 4:
        raise ValueError(f"C must be a multiple of 4, got {c}")
    if not 1 <= output_size <= MAX_OUTPUT \
            or not 1 <= sampling_ratio <= MAX_SAMPLING:
        raise ValueError(f"need 1 <= output_size <= {MAX_OUTPUT} and 1 <= "
                         f"sampling_ratio <= {MAX_SAMPLING}, got "
                         f"{output_size}, {sampling_ratio}")
    if b * n >= 2 ** 31:
        raise ValueError(f"too many boxes: {b * n}")
    if not all(m.is_contiguous(memory_format=torch.channels_last)
               for m in maps):
        raise ValueError("maps must be channels-last")


def _pyramid(maps, strides):
    """The level table `csrc/roi_align.cu:make_pyramid` reads."""
    k = len(maps)
    return ((ctypes.c_void_p * k)(*(m.data_ptr() for m in maps)),
            (ctypes.c_int * k)(*(m.shape[2] for m in maps)),
            (ctypes.c_int * k)(*(m.shape[3] for m in maps)),
            (ctypes.c_float * k)(*map(float, strides)), k)


def forward(maps, boxes, level, output_size, strides, min_level,
            sampling_ratio):
    """maps (B, C, H_l, W_l) float32 finest first, boxes (B, N, 4) float32
    contiguous, level (B, N) int64 -> (pooled (B, N, out, out, C), the maps
    as the kernel reads them: channels-last, for `backward`) from one
    launch.  Raises on another device, dtype or shape than the kernel
    takes (float32, C a multiple of 4, at most 4 levels, out <= 32,
    sampling_ratio 1 or 2)."""
    if boxes.device.type != "cuda":
        raise ValueError(f"roi_align_pyramid: unsupported device "
                         f"{boxes.device}")
    maps = [m.contiguous(memory_format=torch.channels_last) for m in maps]
    _check(maps, boxes, output_size, strides, sampling_ratio)
    b, n = boxes.shape[:2]
    c = maps[0].shape[1]
    out = torch.empty((b, n, output_size, output_size, c),
                      dtype=torch.float32, device=boxes.device)
    ptrs, hs, ws, st, k = _pyramid(maps, strides)
    with torch.cuda.device(boxes.device):
        err = library().mot3d_roi_align_forward(
            ptrs, hs, ws, st, k, min_level, boxes.data_ptr(),
            level.data_ptr(), out.data_ptr(), b * n, n, output_size,
            sampling_ratio, c, torch.cuda.current_stream().cuda_stream)
    check(err, "roi_align_forward")
    launches.count += 1
    return out, maps


def backward(maps, boxes, level, grad, need_maps, need_boxes, output_size,
             strides, min_level, sampling_ratio):
    """(level gradients or None, box gradient or None) from one launch, for
    `forward`'s maps, boxes and level and grad (B, N, out, out, C)
    contiguous.  Under `torch.use_deterministic_algorithms` it warns, or
    raises without `warn_only`, as PyTorch's own atomic scatters do (the
    condition is in the module's docstring)."""
    if torch.are_deterministic_algorithms_enabled():
        msg = ("roi_align_backward_kernel adds into float64 sums by "
               "atomicAdd in no fixed order: exact, and the same from run "
               "to run, only while the absolute addends of a sum add up to "
               "less than 2**29 times the smallest")
        if not torch.is_deterministic_algorithms_warn_only_enabled():
            raise RuntimeError(msg)
        warnings.warn(msg, stacklevel=2)
    b, n = boxes.shape[:2]
    c = maps[0].shape[1]
    sizes = [m.numel() for m in maps]
    flat = grads = gboxes = None
    if need_maps:
        # One zeroed float64 buffer, one (B, H, W, C) level after another.
        flat = torch.zeros(sum(sizes), dtype=torch.float64,
                           device=boxes.device)
        grads = (ctypes.c_void_p * len(maps))(
            *(part.data_ptr() for part in flat.split(sizes)))
    if need_boxes:
        gboxes = torch.zeros(boxes.shape, dtype=torch.float64,
                             device=boxes.device)
    ptrs, hs, ws, st, k = _pyramid(maps, strides)
    with torch.cuda.device(boxes.device):
        err = library().mot3d_roi_align_backward(
            ptrs, grads, hs, ws, st, k, min_level, boxes.data_ptr(),
            level.data_ptr(), grad.data_ptr(),
            None if gboxes is None else gboxes.data_ptr(), b * n, n,
            output_size, sampling_ratio, c,
            torch.cuda.current_stream().cuda_stream)
    check(err, "roi_align_backward")
    backward_launches.count += 1
    gmaps = None if flat is None else [
        part.view(b, m.shape[2], m.shape[3], c).permute(0, 3, 1, 2)
        for part, m in zip(flat.float().split(sizes), maps)]
    return gmaps, None if gboxes is None else gboxes.float()
