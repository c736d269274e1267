"""ROIAlign over an FPN pyramid as two einsums (counterpart of
`mot3d_tpu/ops/roi_align.py`: `multilevel_roi_align_packed`, its batched
form, and the single-level `roi_align_matmul` that pools the training mask
targets).

Semantics are detectron2 ROIAlignV2 (aligned=True): half-pixel offset,
`sampling_ratio` x `sampling_ratio` samples per output bin, average-pooled,
zero outside the feature map; each box pools from its FPN level
floor(4 + log2(sqrt(area) / 224)).  ROIAlign is linear and separable per
axis, so each box's pooled patch is Ry (out, H) @ F (H, W, C) @ Rx^T
(W, out).  The pyramid is packed into one (C, sum_l H_l, max_l W_l) map
(levels stacked along y, x zero-padded) and each box's weights are built
against the packed axes at its own level's offset, so one einsum pair pools
and level-selects every box.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _bilinear_weights(coord: torch.Tensor, size):
    """Fractional positions -> (i0, i1, w0, w1), zero weight outside
    [-1, size)."""
    valid = (coord > -1.0) & (coord < size)
    c = torch.minimum(torch.clamp(coord, min=0.0), size - 1.0)
    i0 = torch.floor(c)
    i1 = torch.minimum(i0 + 1, size - 1.0)
    w1 = c - i0
    w0 = 1.0 - w1
    zero = torch.zeros_like(w0)
    return (i0.long(), i1.long(), torch.where(valid, w0, zero),
            torch.where(valid, w1, zero))


def _map_weights(boxes: torch.Tensor, output_size: int, h: int, w: int,
                 spatial_scale: float, sampling_ratio: int):
    """Per-axis ROIAlignV2 weights of boxes (N, 4) on one (h, w) map:
    rows (N, out, h) and columns (N, out, w)."""
    b = boxes * spatial_scale - 0.5
    zero = torch.zeros(b.shape[0], dtype=torch.long, device=b.device)

    def weights(lo, hi, size):          # one map: size `size`, offset 0
        return _packed_roi_weights(lo, hi, output_size, sampling_ratio,
                                   torch.full_like(lo, float(size)), zero,
                                   size)

    return weights(b[:, 1], b[:, 3], h), weights(b[:, 0], b[:, 2], w)


def roi_align_matmul(feature: torch.Tensor, boxes: torch.Tensor,
                     output_size: int, spatial_scale: float = 1.0,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """Single-level ROIAlignV2 as two separable weight matmuls: feature
    (H, W, C) channels-last, boxes (N, 4) XYXY -> (N, out, out, C)."""
    h, w, _ = feature.shape
    ry, cx = _map_weights(boxes, output_size, h, w, spatial_scale,
                          sampling_ratio)
    rows = torch.einsum("nih,hwc->niwc", ry.to(feature.dtype), feature)
    return torch.einsum("niwc,njw->nijc", rows, cx.to(rows.dtype))


def roi_align_own_map(maps: torch.Tensor, boxes: torch.Tensor,
                      output_size: int, sampling_ratio: int = 2
                      ) -> torch.Tensor:
    """Box i pools map i only: maps (N, H, W), boxes (N, 4) XYXY ->
    (N, out, out), the diagonal of `roi_align_matmul` over the channels
    (the exporter's GT masks as oracle 28 x 28 mask probabilities)."""
    h, w = maps.shape[-2:]
    ry, cx = _map_weights(boxes, output_size, h, w, 1.0, sampling_ratio)
    rows = torch.einsum("nih,nhw->niw", ry.to(maps.dtype), maps)
    return torch.einsum("niw,njw->nij", rows, cx.to(rows.dtype))


def _packed_roi_weights(lo, hi, out: int, s: int, sizes, offsets,
                        total: int) -> torch.Tensor:
    """Combined per-axis ROIAlignV2 weights against a packed axis.

    lo/hi (N,) box extent in its level's coords (already -0.5); sizes (N,)
    that level's extent; offsets (N,) its start inside the packed axis.
    Returns (N, out, total); rows of other levels get zero weight."""
    dev = lo.device
    cell = (torch.arange(out, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev)[None, :]
               + 0.5) / s)                                   # (out, s)
    bin_sz = (hi - lo) / out
    pos = lo[:, None, None] + cell[None] * bin_sz[:, None, None]
    i0, i1, w0, w1 = _bilinear_weights(pos, sizes[:, None, None])
    iota = torch.arange(total, device=dev)
    off = offsets[:, None, None, None]
    oh0 = ((i0[..., None] + off) == iota).to(w0.dtype) * w0[..., None]
    oh1 = ((i1[..., None] + off) == iota).to(w1.dtype) * w1[..., None]
    return (oh0 + oh1).sum(2) / s


def assign_fpn_level(boxes: torch.Tensor, min_level: int = 2,
                     max_level: int = 5, canonical_size: float = 224.0,
                     canonical_level: int = 4) -> torch.Tensor:
    """Box -> FPN level floor(L0 + log2(sqrt(area) / 224))."""
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    scale = torch.sqrt(torch.clamp(area, min=1e-12))
    lvl = torch.floor(canonical_level
                      + torch.log2(scale / canonical_size + 1e-12))
    return torch.clamp(lvl, min_level, max_level).long()


def multilevel_roi_align_packed(features: Sequence[torch.Tensor],
                                boxes: torch.Tensor, output_size: int,
                                strides: Sequence[int], min_level: int = 2,
                                sampling_ratio: int = 2) -> torch.Tensor:
    """One image: features (C, H_l, W_l) finest first, boxes (N, 4) XYXY in
    image coords -> (N, out, out, C) (channels-last, as in JAX)."""
    dims = [(f.shape[-2], f.shape[-1]) for f in features]
    w_max = max(w for _, w in dims)
    h_tot = sum(h for h, _ in dims)
    packed = torch.cat([F.pad(f, (0, w_max - f.shape[-1])) for f in features],
                       dim=-2)                               # (C, h_tot, w_max)
    yoffs = [sum(h for h, _ in dims[:i]) for i in range(len(dims))]

    li = assign_fpn_level(boxes, min_level,
                          min_level + len(features) - 1) - min_level

    def per_box(values, dtype=torch.float32):
        out = torch.zeros(li.shape, dtype=dtype, device=li.device)
        for lvl, v in enumerate(values):
            out = torch.where(li == lvl, v, out)
        return out

    h_l = per_box([h for h, _ in dims])
    w_l = per_box([w for _, w in dims])
    yoff = per_box(yoffs, torch.long)
    stride_l = per_box([float(s) for s in strides])

    out, s = output_size, sampling_ratio
    b = boxes / stride_l[:, None] - 0.5
    ry = _packed_roi_weights(b[:, 1], b[:, 3], out, s, h_l, yoff, h_tot)
    rx = _packed_roi_weights(b[:, 0], b[:, 2], out, s, w_l,
                             torch.zeros_like(yoff), w_max)
    t1 = torch.einsum("nph,chw->npwc", ry.to(packed.dtype), packed)
    return torch.einsum("npwc,nqw->npqc", t1, rx.to(t1.dtype))


def multilevel_roi_align_batched_packed(features: Sequence[torch.Tensor],
                                        boxes: torch.Tensor,
                                        output_size: int,
                                        strides: Sequence[int],
                                        min_level: int = 2,
                                        sampling_ratio: int = 2
                                        ) -> torch.Tensor:
    """A batch of images: features (B, C, H_l, W_l), boxes (B, N, 4) ->
    (B, N, out, out, C), each image's boxes pooled from its own pyramid."""
    return torch.stack([
        multilevel_roi_align_packed([f[i] for f in features], boxes[i],
                                    output_size, strides, min_level,
                                    sampling_ratio)
        for i in range(boxes.shape[0])])
