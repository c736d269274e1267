"""Padded sequence-graph construction (counterpart of
`mot3d_tpu/tracking/graph_builder.py`).

Replacement for the reference's `GraphDataset.get_edge_data`
(`Tracking/datasets/graph_dataset.py:31-214`): the edge structure is a
static template (every (frame t, slot i) x (frame t+dt, slot j) pair for dt
in [1, max_frame_dist]) built once per config with numpy; the per-sequence
work — edge features, GT identity matching by BEV 3D IoU, targets — is one
batched tensor pass with validity masks.

Semantics mirrored from the reference:
  - GT identity: max 3D IoU vs GT boxes, assigned if >= box_iou_thres;
    unmatched detections are false positives and leave the graph;
  - edge features [dPosition(3), dRotation-euler(3), log scale ratio(1),
    dt(1)] with the later frame as destination; optional |dAppearance| and
    quaternion rotations;
  - undirected graphs duplicate edges with identical features;
  - consecutive_mask marks dt == 1 edges on the forward half.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import TrackingConfig
from mot3d_tpu_torch.geometry.iou3d import box3d_iou_matrix
from mot3d_tpu_torch.geometry.transforms import quaternion_from_euler


class GraphTemplate(NamedTuple):
    """Static edge structure over directed-forward edges E (host numpy)."""

    src_frame: np.ndarray   # (E,) frame t
    src_slot: np.ndarray    # (E,) instance slot in frame t
    dst_frame: np.ndarray   # (E,) frame t + dt
    dst_slot: np.ndarray    # (E,)
    dt: np.ndarray          # (E,)
    num_nodes: int
    max_instances: int
    seq_len: int


@functools.lru_cache(maxsize=8)
def make_template(seq_len: int, max_instances: int,
                  max_frame_dist: int) -> GraphTemplate:
    src_f, src_s, dst_f, dst_s, dts = [], [], [], [], []
    for t in range(seq_len - 1):
        for dt in range(1, min(max_frame_dist, seq_len - 1 - t) + 1):
            for i in range(max_instances):
                for j in range(max_instances):
                    src_f.append(t)
                    src_s.append(i)
                    dst_f.append(t + dt)
                    dst_s.append(j)
                    dts.append(dt)
    return GraphTemplate(
        np.array(src_f, np.int32), np.array(src_s, np.int32),
        np.array(dst_f, np.int32), np.array(dst_s, np.int32),
        np.array(dts, np.int32), seq_len * max_instances, max_instances,
        seq_len,
    )


class PaddedGraph(NamedTuple):
    """One sequence graph, fully padded.  E2 = 2 * E (undirected)."""

    src: torch.Tensor             # (E2,) int64 node indices (frame * I + slot)
    dst: torch.Tensor             # (E2,)
    edge_attr: torch.Tensor       # (E2, edge_dim)
    edge_mask: torch.Tensor       # (E2,) bool — both endpoints usable
    targets: torch.Tensor         # (E2,) float {0, 1} same-GT-identity
    consec_mask: torch.Tensor     # (E2,) bool — dt == 1 and forward half
    forward_mask: torch.Tensor    # (E2,) bool — first (directed) copy
    obj_ids: torch.Tensor         # (T, I) int32 matched GT id, -1 = FP
    node_valid: torch.Tensor      # (T * I,) bool
    false_positives: torch.Tensor  # () int32 — unmatched valid detections


def match_gt_identity(pred_boxes, det_valid, gt_boxes, gt_ids, gt_valid,
                      iou_thres: float):
    """GT identity by max 3D IoU (>= iou_thres), batched over leading dims.

    pred_boxes (..., I, 8, 3); det_valid (..., I); gt_boxes (..., G, 8, 3);
    gt_ids (..., G); gt_valid (..., G).  Returns (..., I) int32 matched ids,
    -1 where unmatched or invalid."""
    iou = box3d_iou_matrix(pred_boxes, gt_boxes)              # (..., I, G)
    iou = torch.where(gt_valid[..., None, :], iou, torch.full_like(iou, -1))
    best = torch.argmax(iou, -1)
    best_iou = torch.gather(iou, -1, best[..., None])[..., 0]
    matched = (best_iou >= iou_thres) & det_valid
    ids = torch.gather(gt_ids, -1, best)
    return torch.where(matched, ids, torch.full_like(ids, -1)).to(torch.int32)


def build_graph(template: GraphTemplate, cfg: TrackingConfig,
                det_valid: torch.Tensor,        # (T, I) bool
                translations: torch.Tensor,     # (T, I, 3) world
                rotations: torch.Tensor,        # (T, I, 3) euler
                scales: torch.Tensor,           # (T, I)
                pred_boxes: torch.Tensor,       # (T, I, 8, 3)
                gt_boxes: torch.Tensor,         # (T, G, 8, 3)
                gt_ids: torch.Tensor,           # (T, G) int32
                gt_valid: torch.Tensor,         # (T, G) bool
                appearance: Optional[torch.Tensor] = None,  # (T, I, D)
                with_targets: bool = True) -> PaddedGraph:
    """The padded graph of one sequence.  With `with_targets=False`
    (office / no-GT mode) all valid-detection pairs become edges and the
    targets are zeros."""
    dev = det_valid.device
    t_frames, i_slots = det_valid.shape

    if with_targets:
        obj_ids = match_gt_identity(pred_boxes, det_valid, gt_boxes, gt_ids,
                                    gt_valid, cfg.box_iou_thres)
    else:
        obj_ids = torch.where(det_valid, 0, -1).to(torch.int32)
    false_positives = (det_valid & (obj_ids < 0)).sum().to(torch.int32)

    sf, ss, df, ds, dts = (torch.as_tensor(a, dtype=torch.long, device=dev)
                           for a in (template.src_frame, template.src_slot,
                                     template.dst_frame, template.dst_slot,
                                     template.dt))

    def gather(arr):
        return arr[sf, ss], arr[df, ds]

    t_s, t_d = gather(translations)
    r_s, r_d = gather(rotations)
    s_s, s_d = gather(scales)
    v_s, v_d = gather(det_valid)
    id_s, id_d = gather(obj_ids)

    if cfg.as_quaternion:
        rel_rot = quaternion_from_euler(r_d) - quaternion_from_euler(r_s)
    else:
        rel_rot = r_d - r_s
    rel_scale = torch.log(torch.clamp(s_d, min=1e-12)
                          / torch.clamp(s_s, min=1e-12))
    feats = [t_d - t_s, rel_rot, rel_scale[:, None],
             dts[:, None].to(translations.dtype)]
    if cfg.use_appearance:
        a_s, a_d = gather(appearance)
        feats.append(torch.linalg.norm(a_d - a_s, dim=-1, keepdim=True))
    edge_attr = torch.cat(feats, dim=-1)

    if with_targets:
        edge_mask = v_s & (id_s >= 0) & v_d & (id_d >= 0)
        targets = (edge_mask & (id_s == id_d)).to(edge_attr.dtype)
    else:
        edge_mask = v_s & v_d
        targets = edge_attr.new_zeros(edge_attr.shape[0])

    src = sf * i_slots + ss
    dst = df * i_slots + ds
    consec = edge_mask & (dts == 1)
    e = src.shape[0]
    if cfg.undirected:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
        edge_attr = torch.cat([edge_attr, edge_attr])
        edge_mask = torch.cat([edge_mask, edge_mask])
        targets = torch.cat([targets, targets])
        consec = torch.cat([consec, torch.zeros_like(consec)])
        fwd = torch.arange(2 * e, device=dev) < e
    else:
        fwd = torch.ones(e, dtype=torch.bool, device=dev)

    return PaddedGraph(
        src=src, dst=dst, edge_attr=edge_attr, edge_mask=edge_mask,
        targets=targets, consec_mask=consec, forward_mask=fwd,
        obj_ids=obj_ids, node_valid=det_valid.reshape(-1),
        false_positives=false_positives)
