"""Masked segment reductions over padded edge arrays
(counterpart of `mot3d_tpu/ops/segment.py`).

Rows are grouped by `segment_ids` into `num_segments` buckets; masked rows
contribute nothing, and empty buckets come out as 0 (torch_scatter's
behaviour, which the MPN aggregation of the reference relies on).
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Sum rows of `data` (E, D) into `num_segments` buckets."""
    if mask is not None:
        data = torch.where(mask[:, None], data, torch.zeros_like(data))
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Mean over valid rows per segment (empty segments -> 0)."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    ones = data.new_ones(data.shape[0])
    if mask is not None:
        ones = ones * mask.to(data.dtype)
    counts = data.new_zeros(num_segments).index_add_(
        0, segment_ids.long(), ones)
    return total / torch.clamp(counts, min=1.0)[:, None]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Max over valid rows per segment (empty segments -> 0)."""
    neg = torch.full_like(data, -torch.inf)
    if mask is not None:
        data = torch.where(mask[:, None], data, neg)
    out = data.new_full((num_segments,) + data.shape[1:], -torch.inf)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    out = out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                             include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
