"""Siamese (non-graph) tracker (counterpart of `mot3d_tpu/models/siamese.py`).

The reference's `--use_graph=False` path (`Tracking/trainer.py:33-978`,
`Tracking/datasets/siamese_dataset.py`): consecutive-frame instance pairs
only; an MLP embeds the relative pose (7 values: dPosition, dRotation,
log-scale), which is concatenated with the two 12-d voxel appearance
embeddings and classified.  Ablations (`Tracking/options.py:36-83`, wiring
`Tracking/trainer.py:50-70`):

  - default:     classify [h_i, h_j, e_ij]                    (in_dim 32)
  - `no_pose`:   no edge encoder; classify [h_i, h_j]          (in_dim 24)
  - `no_geo`:    no voxel encoder; classify e_ij alone         (in_dim 8)
  - `use_triplet`: triplet margin loss on the appearance embeddings, with
    per-anchor positive and negative mining (`siamese_dataset.py:115-283`)
  - `use_l1`: L1 on sigmoid(logits) instead of the balanced BCE
    (`Tracking/trainer.py:815-817`)

The pairs are the padded graph template restricted to dt == 1; a
sequence's pairs are classified in one batched pass, and triplet mining is
two segment-max reductions over the same padded edges instead of the
reference's triple Python loop.  Submodule names follow the flax tree
(`importers/flax_params.py:siamese_state_dict`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mot3d_tpu_torch.config import SiameseConfig
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.models.mpn import MLP, EdgeClassifier, VoxelEncoder
from mot3d_tpu_torch.models.rpn import softplus

REL_POSE_DIM = 7


class SiameseTracker(nn.Module):
    """Voxel encoder (12-d, `Tracking/trainer.py:48`) + relative-pose edge
    encoder MLP(7 -> [8, 8]) (`trainer.py:58`) + a classifier over the
    ablation's concatenation (`trainer.py:56-67`)."""

    def __init__(self, cfg: SiameseConfig, device=None):
        super().__init__()
        self.cfg = cfg
        in_dim = 0
        if not cfg.no_geo:
            self.voxel_encoder = VoxelEncoder(cfg.appearance_dim)
            in_dim += 2 * cfg.appearance_dim
        if not cfg.no_pose:
            self.edge_encoder = MLP(REL_POSE_DIM, (8, cfg.edge_out_dim))
            in_dim += cfg.edge_out_dim
        self.classifier = EdgeClassifier(in_dim, cfg.classifier_intermed_dim)
        self.to(resolve_device(device))

    def encode(self, voxels: torch.Tensor) -> torch.Tensor:
        """Appearance embeddings (N, appearance_dim): the part the
        precompute path caches (`Tracking/trainer.py:396-449`)."""
        if self.cfg.no_geo:
            raise ValueError("no_geo model has no voxel encoder")
        return self.voxel_encoder(voxels)

    def classify(self, h: Optional[torch.Tensor], src, dst, rel_pose,
                 edge_mask) -> torch.Tensor:
        """(E,) logits of the pairs from (pre)computed embeddings h (N, D)
        (None under no_geo); masked slots are 0."""
        feats = []
        if not self.cfg.no_geo:
            src, dst = src.long(), dst.long()
            feats += [h[src], h[dst]]
        if not self.cfg.no_pose:
            feats.append(self.edge_encoder(rel_pose))
        logits = self.classifier(torch.cat(feats, -1))[..., 0]
        return torch.where(edge_mask, logits, torch.zeros_like(logits))

    def forward(self, voxels, src, dst, rel_pose, edge_mask):
        """voxels (N, 32, 32, 32); src, dst (E,); rel_pose (E, 7) ->
        ((E,) logits, (N, D) embeddings or None)."""
        h = None if self.cfg.no_geo else self.encode(voxels)
        return self.classify(h, src, dst, rel_pose, edge_mask), h


def siamese_edge_features(graph_edge_attr: torch.Tensor) -> torch.Tensor:
    """[dPos(3), dRot(3), log-scale(1)]: the graph builder's edge features
    without dt (`siamese_dataset.py:8-41` compute_edge_emb)."""
    return graph_edge_attr[..., :REL_POSE_DIM]


def siamese_bce_loss(logits, targets, mask, pos_weight_max: float = 10.0,
                     logit_clamp: float = 100.0) -> torch.Tensor:
    """Balanced BCE, pos_weight = #neg / #pos clamped at 10 and logits
    clamped to +-100 (`Tracking/trainer.py:807-829`)."""
    mask_f = mask.to(logits.dtype)
    targets = targets.to(logits.dtype)
    logits = torch.clamp(logits, -logit_clamp, logit_clamp)
    num_all = torch.clamp(mask_f.sum(), min=1.0)
    num_pos = (targets * mask_f).sum()
    pos_weight = torch.where(
        num_pos > 0,
        torch.clamp((num_all - num_pos) / torch.clamp(num_pos, min=1.0),
                    max=pos_weight_max),
        torch.ones_like(num_pos))
    per_edge = (pos_weight * targets * softplus(-logits)
                + (1.0 - targets) * softplus(logits))
    return (per_edge * mask_f).sum() / num_all


def siamese_l1_loss(logits, targets, mask) -> torch.Tensor:
    """L1 on sigmoid(logits), the mean over valid pairs
    (`Tracking/trainer.py:815-817`)."""
    mask_f = mask.to(logits.dtype)
    err = (torch.sigmoid(logits) - targets.to(logits.dtype)).abs()
    return (err * mask_f).sum() / torch.clamp(mask_f.sum(), min=1.0)


def mine_triplets(h, src, dst, targets, edge_mask):
    """Per-anchor positive and negative mining over padded forward dt == 1
    pairs (`siamese_dataset.py:115-283`): for instance n of frame t the
    anchor is its embedding, the positive the last same-identity match in
    frame t + 1 and the negative the last different-identity instance
    there; "last in loop order" is the segment max of the edge index by
    source node.  A triplet is valid only when both exist.

    h (N, D); src, dst (E,); targets (E,) in {0, 1}; edge_mask (E,) ->
    (anchor, positive, negative) each (N, D) and a (N,) validity mask."""
    n = h.shape[0]
    src, dst = src.long(), dst.long()
    e_idx = torch.arange(src.shape[0], device=src.device)
    none = torch.full_like(e_idx, -1)

    def last(sel):
        picked = torch.where(sel, e_idx, none)
        return torch.full((n,), -1, dtype=e_idx.dtype,
                          device=src.device).scatter_reduce(
            0, src, picked, "amax", include_self=True)

    pos_edge = last(edge_mask & (targets > 0.5))
    neg_edge = last(edge_mask & (targets < 0.5))
    valid = (pos_edge >= 0) & (neg_edge >= 0)
    positive = h[dst[torch.clamp(pos_edge, min=0)]]
    negative = h[dst[torch.clamp(neg_edge, min=0)]]
    return h, positive, negative, valid


def triplet_loss(anchor, positive, negative, valid=None,
                 margin: float = 1.0) -> torch.Tensor:
    """Euclidean triplet margin loss (`Tracking/trainer.py:91-94,833-840`,
    nn.TripletMarginLoss(margin=1, p=2)), the mean over valid anchors.  The
    sqrt has an epsilon: a padded anchor can pair identical embeddings, and
    the gradient of sqrt at 0 would make the masked term NaN."""
    def dist(a, b):
        return torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12)

    per = torch.clamp(dist(anchor, positive) - dist(anchor, negative)
                      + margin, min=0.0)
    if valid is None:
        return per.mean()
    v = valid.to(per.dtype)
    return (per * v).sum() / torch.clamp(v.sum(), min=1.0)
