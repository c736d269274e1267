"""Tracker networks: voxel encoder, message-passing graph net, edge
classifier, and the tracking loss (counterpart of
`mot3d_tpu/models/mpn.py`).

The graph is a dense padded edge tensor with validity masks, and node
aggregation uses the masked segment ops of `ops/segment.py`.  Submodule
names follow the flax parameter tree (`Dense_0`, `Conv_0`, ...) so
`importers/flax_params.py` maps one onto the other by name.

Architecture (`Tracking/graph_cfg.py:3-35`):
  - VoxelEncoder (`Tracking/networks/voxel_encoder.py:5-42`): 3D CNN
    32^3 -> strided convs (8, 16, 32, 32 ch) -> FC 2048 -> 256 -> out;
  - MPGraph (`Tracking/networks/mpn.py:119-254`): edge-encoder MLP; per
    step the edge MLP updates e_ij from [h_i, h_j, e_init || e_ij] and the
    node MLP updates h_i from [h_i, aggregate of its edges] (time-aware:
    separate flow-in and flow-out MLPs over the backward and forward edges,
    fused by a third); the edge states of steps 2..S are returned;
  - EdgeClassifier (`Tracking/networks/edge_classifier.py:9-24`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mot3d_tpu_torch.config import GraphConfig
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.models.rpn import softplus
from mot3d_tpu_torch.ops.segment import segment_max, segment_mean, segment_sum


class MLP(nn.Module):
    """Linear stack with LeakyReLU (ReLU when use_leaky_relu is False), no
    activation after a 1-wide layer (`Tracking/networks/mlp.py:4-34`)."""

    def __init__(self, in_dim: int, fc_dims: Sequence[int],
                 use_leaky_relu: bool = True):
        super().__init__()
        self.dims = tuple(fc_dims)
        self.use_leaky_relu = use_leaky_relu
        for i, dim in enumerate(self.dims):
            self.add_module(f"Dense_{i}", nn.Linear(in_dim, dim))
            in_dim = dim

    def forward(self, x):
        for i, dim in enumerate(self.dims):
            x = getattr(self, f"Dense_{i}")(x)
            if dim != 1:
                x = F.leaky_relu(x) if self.use_leaky_relu else F.relu(x)
        return x


class VoxelEncoder(nn.Module):
    """(..., 32, 32, 32) occupancy grids -> (..., out_dim) embeddings."""

    def __init__(self, out_dim: int = 16):
        super().__init__()
        chans = (1, 8, 16, 32, 32)
        for i in range(4):
            self.add_module(f"Conv_{i}", nn.Conv3d(
                chans[i], chans[i + 1], 3, stride=1 if i == 0 else 2,
                padding=1))
        self.Dense_0 = nn.Linear(32 * 4 * 4 * 4, 256)
        self.Dense_1 = nn.Linear(256, out_dim)

    def forward(self, vox):
        lead = vox.shape[:-3]
        x = vox.reshape((-1, 1) + vox.shape[-3:]).to(self.Dense_0.weight.dtype)
        x = self.Conv_0(x)
        for i in range(1, 4):
            x = getattr(self, f"Conv_{i}")(F.relu(x))
        # Flatten channels-last, as the NDHWC flax model does.
        x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        x = self.Dense_0(F.leaky_relu(x))
        x = self.Dense_1(F.leaky_relu(x))
        return x.reshape(lead + (x.shape[-1],))


class EdgeClassifier(nn.Module):
    """Active / non-active edge classifier -> logits (..., 1)."""

    def __init__(self, in_dim: int, intermed_dim: int = 8):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, intermed_dim)
        self.Dense_1 = nn.Linear(intermed_dim, 1)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


_AGGREGATE = {"mean": segment_mean, "max": segment_max, "sum": segment_sum}


class MPGraph(nn.Module):
    """Dense-padded message passing.

    forward(node_feats (N, node_dim), src, dst (E,), edge_attr
    (E, edge_in), edge_mask (E,)) -> list of (E, edge_out) edge states after
    steps 2..S."""

    def __init__(self, cfg: GraphConfig):
        super().__init__()
        if cfg.node_agg_fn not in _AGGREGATE:
            raise ValueError(f"unknown node_agg_fn {cfg.node_agg_fn!r}")
        self.cfg = cfg
        e_dim = cfg.edge_out_dim
        h_dim = cfg.node_dim
        self.edge_encoder = MLP(cfg.edge_in_dim,
                                tuple(cfg.edge_fc_dims) + (e_dim,),
                                cfg.use_leaky_relu)
        h_in = 2 * h_dim if cfg.reattach_initial_nodes else h_dim
        e_in = 2 * e_dim if cfg.reattach_initial_edges else e_dim
        self.edge_model = MLP(2 * h_in + e_in, cfg.edge_model_fc_dims,
                              cfg.use_leaky_relu)
        msg_dim = cfg.edge_model_fc_dims[-1]
        if cfg.time_aware_mp:
            for name in ("flow_in", "flow_out"):
                self.add_module(name, MLP(h_in + msg_dim,
                                          cfg.node_model_fc_dims,
                                          cfg.use_leaky_relu))
            self.node_fuse = MLP(2 * cfg.node_model_fc_dims[-1],
                                 cfg.node_model_fc_dims, cfg.use_leaky_relu)
        else:
            self.node_model = MLP(h_dim + msg_dim, cfg.node_model_fc_dims,
                                  cfg.use_leaky_relu)

    def forward(self, node_feats, src, dst, edge_attr, edge_mask):
        g = self.cfg
        act = F.leaky_relu if g.use_leaky_relu else F.relu
        num_nodes = node_feats.shape[0]
        src, dst = src.long(), dst.long()
        e = self.edge_encoder(edge_attr)
        h = act(node_feats)
        e0, h0 = e, h
        agg = _AGGREGATE[g.node_agg_fn]
        outputs = []
        for step in range(1, g.num_mp_steps + 1):
            e_in = torch.cat([e0, e], -1) if g.reattach_initial_edges else e
            h_in = torch.cat([h0, h], -1) if g.reattach_initial_nodes else h
            e = self.edge_model(torch.cat([h_in[src], h_in[dst], e_in], -1))
            if g.time_aware_mp:
                # Grouped by src: forward-in-time edges (src < dst) carry
                # the flow out of a node, backward ones the flow into it.
                hd_e = torch.cat([h_in[dst], e], -1)
                fo = agg(self.flow_out(hd_e), src, num_nodes,
                         edge_mask & (src < dst))
                fi = agg(self.flow_in(hd_e), src, num_nodes,
                         edge_mask & (src > dst))
                h = self.node_fuse(torch.cat([fi, fo], -1))
            else:
                h = self.node_model(torch.cat(
                    [h, agg(e, src, num_nodes, edge_mask)], -1))
            if step > 1:
                outputs.append(e)
        return outputs


class TrackerModel(nn.Module):
    """Voxel encoder + MPN + edge classifier (`Tracking/mpn_trainer.py:50-71`).

    forward(voxels (N, 32, 32, 32), src, dst (E,), edge_attr (E, edge_in),
    edge_mask (E,)) -> (num_classified_steps, E) logits."""

    def __init__(self, cfg: GraphConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.voxel_encoder = VoxelEncoder(cfg.node_dim)
        self.graph_net = MPGraph(cfg)
        self.edge_classifier = EdgeClassifier(cfg.edge_model_fc_dims[-1],
                                              cfg.classifier_intermed_dim)
        self.to(resolve_device(device))

    def forward(self, voxels, src, dst, edge_attr, edge_mask):
        node_feats = self.voxel_encoder(voxels)
        states = self.graph_net(node_feats, src, dst, edge_attr, edge_mask)
        return torch.stack([self.edge_classifier(s)[..., 0] for s in states])


def balanced_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Balanced BCE with pos_weight = #neg / #pos over the valid edges
    (`Tracking/mpn_trainer.py:811-830`): mean over valid edges of
    pos_weight * y * softplus(-x) + (1 - y) * softplus(x).  logits,
    targets, mask (..., E); returns (...,)."""
    mask_f = mask.to(logits.dtype)
    targets = targets.to(logits.dtype)
    num_all = torch.clamp(mask_f.sum(-1), min=1.0)
    num_pos = (targets * mask_f).sum(-1)
    pos_weight = torch.where(num_pos > 0,
                             (num_all - num_pos)
                             / torch.clamp(num_pos, min=1.0),
                             torch.ones_like(num_pos))
    per_edge = (pos_weight[..., None] * targets * softplus(-logits)
                + (1.0 - targets) * softplus(logits))
    return (per_edge * mask_f).sum(-1) / num_all


def tracker_loss(logits_steps: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Deep supervision: mean of the balanced BCE over each classified MP
    step (`Tracking/mpn_trainer.py:500-516`); logits_steps (S, E)."""
    return balanced_bce_loss(logits_steps, targets, mask).mean()
