"""Pose pipeline: NOCS + depth -> 7-DoF similarity -> world boxes
(counterpart of `mot3d_tpu/pose/pipeline.py`).

Re-design of `PoseEst/pose_estimation.py` (run_pose :245-412) and the
detect->track bridge `Detection/tracker/postprocess.py:22-238`
(postprocess_dets).  All detection slots of all frames run as one batch:
point extraction, two outlier passes, RANSAC/Umeyama and the world box are
batched tensor ops with leading (frames, slots) dimensions.

Faithful behaviours:
  - optional GT-box depth cleaning, applied only if > 20 points survive;
  - statistical outlier removal on the depth cloud, then on the NOCS cloud,
    each skipped under 100 points;
  - pose = RANSAC + Umeyama CAD->cam (NOCS - 0.5 as source), chained with
    the campose; world box = axis-aligned box of the depth points in world
    space, canonical corner order;
  - rotations exported as XYZ euler of the scale-normalised rotation;
  - gating: objectness > 0.35 (0.01 without GT), max 2D IoU vs GT >= 0.35,
    patch >= 3 px.

Randomness: RANSAC consumes `draws` (raw integers, see
`geometry/umeyama.py`); without them a `torch.Generator` makes them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mot3d_tpu_torch.config import Config
from mot3d_tpu_torch.geometry.iou3d import box2d_iou_matrix
from mot3d_tpu_torch.geometry.outlier import statistical_outlier_mask
from mot3d_tpu_torch.geometry.transforms import (aabb_corners, cam_to_world,
                                                 rotmat_to_euler)
from mot3d_tpu_torch.geometry.umeyama import (estimate_similarity_transform,
                                              make_draws)
from mot3d_tpu_torch.ops.cuda.pose_extract import pose_extract
from mot3d_tpu_torch.ops.precision import strict_fp32
from mot3d_tpu_torch.pose.extraction import grid_extract


class PoseResult(NamedTuple):
    valid: torch.Tensor        # (...,) bool
    rotation: torch.Tensor     # (..., 3, 3) world rotation (scale embedded)
    euler: torch.Tensor        # (..., 3) XYZ euler of the unscaled rotation
    translation: torch.Tensor  # (..., 3) world
    scale: torch.Tensor        # (...,) isotropic
    world_box: torch.Tensor    # (..., 8, 3) canonical AABB of depth points


class FrameDetections(NamedTuple):
    """Padded per-frame tracking inputs (postprocess output), (F, I, ...)."""

    valid: torch.Tensor         # (F, I)
    classes: torch.Tensor       # (F, I)
    rotations: torch.Tensor     # (F, I, 3) euler
    translations: torch.Tensor  # (F, I, 3) world
    scales: torch.Tensor        # (F, I)
    voxels: torch.Tensor        # (F, I, 32, 32, 32) binarised
    pred_boxes: torch.Tensor    # (F, I, 8, 3) world corner boxes
    objectness: torch.Tensor    # (F, I)


def _masked_aabb(points: torch.Tensor, valid: torch.Tensor):
    inf = torch.full_like(points, torch.inf)
    mins = torch.where(valid[..., None], points, inf).amin(-2)
    maxs = torch.where(valid[..., None], points, -inf).amax(-2)
    ok = valid.any(-1)[..., None]
    return (torch.where(ok, mins, torch.zeros_like(mins)),
            torch.where(ok, maxs, torch.zeros_like(maxs)))


@strict_fp32()
def pose_from_points(depth_pts: torch.Tensor, nocs_vals: torch.Tensor,
                     bval: torch.Tensor, campose: torch.Tensor,
                     draws: torch.Tensor, cfg: Config,
                     gt_box3d: Optional[torch.Tensor] = None) -> PoseResult:
    """Pose of detections from extracted point buffers.

    depth_pts (..., P, 3) camera-space points; nocs_vals (..., P, 3) in
    [0, 1]; bval (..., P); campose (..., 4, 4) broadcastable; draws
    (..., iters, S); gt_box3d (..., 8, 3) for GT depth cleaning or None."""
    p = cfg.pose
    if gt_box3d is not None:
        world_pts = cam_to_world(depth_pts, campose)
        inside = ((world_pts > gt_box3d.amin(-2)[..., None, :])
                  & (world_pts < gt_box3d.amax(-2)[..., None, :])).all(-1)
        cleaned = bval & inside
        use_clean = cleaned.sum(-1) > p.clean_depth_min_points
        bval = torch.where(use_clean[..., None], cleaned, bval)

    keep = statistical_outlier_mask(depth_pts, bval, p.outlier_nb_neighbors,
                                    p.outlier_std_ratio, p.outlier_min_points,
                                    candidates=p.outlier_candidates)
    nocs_pts = nocs_vals - 0.5
    keep = statistical_outlier_mask(nocs_pts, keep, p.outlier_nb_neighbors,
                                    p.outlier_std_ratio, p.outlier_min_points,
                                    candidates=p.outlier_candidates)

    if not p.differentiable:
        nocs_pts = nocs_pts.detach()
        depth_pts = depth_pts.detach()

    fit = estimate_similarity_transform(
        nocs_pts, depth_pts, keep, draws, p.ratio_adapt, p.min_inlier_ratio,
        p.stop_divisor, p.solver)

    # Chain CAD->cam with cam->world.
    obj_tocam = torch.eye(4, dtype=depth_pts.dtype, device=depth_pts.device
                          ).repeat(fit.scale.shape + (1, 1))
    obj_tocam[..., :3, :3] = fit.scale[..., None, None] * \
        fit.rotation.transpose(-1, -2)
    obj_tocam[..., :3, 3] = fit.translation
    global_tf = campose @ obj_tocam
    global_rot = global_tf[..., :3, :3]
    global_trans = global_tf[..., :3, 3]

    dmin, dmax = _masked_aabb(cam_to_world(depth_pts, campose), keep)
    world_box = aabb_corners(dmin, dmax)

    col_scale = torch.linalg.norm(global_rot, dim=-2)
    unscaled = global_rot / torch.clamp(col_scale, min=1e-12)[..., None, :]
    euler = rotmat_to_euler(unscaled)

    ok = fit.valid & (keep.sum(-1) >= p.ransac_sample_size)
    return PoseResult(ok, global_rot, euler, global_trans, fit.scale,
                      world_box)


def _check_extraction(cfg: Config) -> None:
    if cfg.pose.extraction == "full":
        raise NotImplementedError(
            "pose.extraction='full' (paste + gather extraction) is not "
            "ported yet: ROADMAP.md Queue 1, item 'Pose stage: full "
            "extraction mode'")
    if cfg.pose.extraction not in ("grid", "pallas"):
        raise ValueError(f"unknown pose.extraction {cfg.pose.extraction!r}")


@strict_fp32()
def postprocess_frames(det_boxes, det_scores, det_classes, det_valid,
                       det_masks, det_voxels, det_nocs, gt_boxes2d, gt_valid,
                       depth, campose, intrinsics, gt_boxes3d_cropped,
                       cfg: Config, use_gt_gate: bool = True,
                       draws: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> FrameDetections:
    """The detect->track bridge for F frames at once.

    det_*: padded detector outputs (F, I, ...); det_masks are the 28x28 mask
    probabilities, det_nocs (F, I, 28, 28, 3); gt_boxes2d (F, M, 4),
    gt_valid (F, M), gt_boxes3d_cropped (F, M, 8, 3); depth (F, H, W);
    campose (F, 4, 4); intrinsics (3, 3); draws (F, I, iters, S) or None.
    With use_gt_gate=False (office mode) the 2D-IoU gate and GT depth
    cleaning are skipped and the objectness gate is 0.01.  All F * I slots
    go through one extraction call: "grid" runs the plain version,
    "pallas" the K2 kernel on a CUDA tensor."""
    _check_extraction(cfg)
    c = cfg.combined
    f_count, i_slots = det_boxes.shape[:2]
    dt = det_boxes.dtype
    depth, campose, intrinsics = (t.to(dt) for t in (depth, campose,
                                                     intrinsics))

    obj_thres = c.objectness_thres if use_gt_gate else c.objectness_office
    keep = det_valid & (det_scores > obj_thres)
    pw = det_boxes[..., 2] - det_boxes[..., 0]
    ph = det_boxes[..., 3] - det_boxes[..., 1]
    keep = keep & ((pw >= 3) | (ph >= 3))

    matched_gt_box3d = None
    if use_gt_gate:
        iou = box2d_iou_matrix(det_boxes, gt_boxes2d)          # (F, I, M)
        iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1))
        best_gt = torch.argmax(iou, -1)
        keep = keep & (iou.amax(-1) >= c.iou2d_thres)
        matched_gt_box3d = torch.gather(
            gt_boxes3d_cropped, 1,
            best_gt[..., None, None].expand(best_gt.shape + (8, 3)))

    if draws is None:
        draws = make_draws((f_count, i_slots, cfg.pose.ransac_iters,
                            cfg.pose.ransac_sample_size), generator,
                           det_boxes.device)

    g = int(round(cfg.pose.max_points ** 0.5))
    extract = pose_extract if cfg.pose.extraction == "pallas" \
        else grid_extract
    s = f_count * i_slots
    feats, bvals = extract(
        det_nocs.reshape((s,) + det_nocs.shape[2:]).to(dt).contiguous(),
        det_masks.reshape((s,) + det_masks.shape[2:]).to(dt).contiguous(),
        det_boxes.reshape(s, 4).contiguous(), depth.contiguous(),
        intrinsics.contiguous(), g)
    feats = feats.reshape(f_count, i_slots, g * g, 6)
    bvals = bvals.reshape(f_count, i_slots, g * g)
    poses = pose_from_points(feats[..., :3], feats[..., 3:], bvals,
                             campose[:, None], draws, cfg, matched_gt_box3d)

    return FrameDetections(
        valid=keep & poses.valid, classes=det_classes,
        rotations=poses.euler, translations=poses.translation,
        scales=poses.scale,
        voxels=(det_voxels >= c.voxel_thres).to(det_voxels.dtype),
        pred_boxes=poses.world_box, objectness=det_scores)


def postprocess_frame(det_boxes, det_scores, det_classes, det_valid,
                      det_masks, det_voxels, det_nocs, gt_boxes2d, gt_valid,
                      depth, campose, intrinsics, gt_boxes3d_cropped,
                      cfg: Config, use_gt_gate: bool = True,
                      draws: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> FrameDetections:
    """One frame (`postprocess_frame` of the JAX package): the inputs of
    `postprocess_frames` without the leading F axis; draws (I, iters, S)."""
    frames = postprocess_frames(
        *(t[None] for t in (det_boxes, det_scores, det_classes, det_valid,
                            det_masks, det_voxels, det_nocs, gt_boxes2d,
                            gt_valid, depth, campose)),
        intrinsics, gt_boxes3d_cropped[None], cfg, use_gt_gate,
        None if draws is None else draws[None], generator)
    return FrameDetections(*(t[0] for t in frames))
