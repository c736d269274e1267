"""Detector inference + per-frame .h5 export, the detect->track handoff
(counterpart of `mot3d_tpu/export.py`).

Mirrors `Detection/inference_detector.py:63-535`: for every scene and
frame, run the detector (or take the ground truth as detections), crop the
GT 3D boxes to the depth-visible extent, fit poses for the gated
detections, log per-class voxel IoU and rotation/location errors, and
write the per-frame `N.h5` files (reference schema, `data/h5_io.py`) that
the tracking trainer consumes.

`DetectorExporter(cfg, det_model, device=None)` runs on the GPU unless the
caller passes `device="cpu"`.  The pose stage runs K1 twice per frame
(depth cloud, NOCS cloud) and, with `pose.extraction="pallas"`, K2 once.
RANSAC draws are an input; `export_split` and `evaluate_samples` make them
from one CPU `torch.Generator` per call seeded by `run.seed`, so a CPU and
a GPU export of the same split draw the same numbers.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import MOTFRONT_CLASSES, Config
from mot3d_tpu_torch.data.detection_loader import (DetectionSample,
                                                   compact_sample, load_frame)
from mot3d_tpu_torch.data.h5_io import FrameDetections, write_frame_h5
from mot3d_tpu_torch.data.motfront import MOTFrontDataset
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.geometry.backproject import make_intrinsics
from mot3d_tpu_torch.geometry.iou3d import box2d_iou_matrix, voxel_iou
from mot3d_tpu_torch.geometry.metrics import (location_error,
                                              rotation_error_deg)
from mot3d_tpu_torch.geometry.transforms import euler_to_rotmat
from mot3d_tpu_torch.geometry.umeyama import make_draws
from mot3d_tpu_torch.models.mask_rcnn import Detections, MaskRCNN
from mot3d_tpu_torch.ops.roi_align import roi_align_own_map
from mot3d_tpu_torch.pose.pipeline import crop_gt_box3d, postprocess_frame


def to_host(tensors, dtype: torch.dtype) -> list:
    """Tensors of one device -> numpy arrays in ONE device-to-host copy:
    each is flattened and cast to `dtype` (exact for bools, class ids and
    values already of that dtype), concatenated, copied and split."""
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors]).cpu()
    out, pos = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[pos:pos + n].reshape(t.shape).numpy())
        pos += n
    return out


class DetectorExporter:
    def __init__(self, cfg: Config, det_model: MaskRCNN, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = det_model.to(self.device)
        self.dtype = next(det_model.parameters()).dtype
        cam = cfg.camera
        self.intrinsics = make_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy,
                                          self.device).to(self.dtype)
        self._cap_warned = False
        self.last_frame: Optional[FrameDetections] = None
        self.last_raw_metrics: Optional[Dict[str, Dict[str, list]]] = None

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).to(
            dtype or self.dtype)

    @torch.no_grad()
    def predict(self, images) -> Detections:
        self.model.eval()
        return self.model.predict(self._t(images))

    @staticmethod
    def _metrics(det_boxes, det_voxels, rotations, translations, gt_boxes,
                 gt_valid, gt_voxels, gt_rotations, gt_locations):
        """Per-detection-slot metric vectors against the best-2D-IoU GT,
        for all slots at once (`inference_detector.py:266-298` matches per
        detection on the host)."""
        iou2 = box2d_iou_matrix(det_boxes, gt_boxes)             # (D, M)
        iou2 = torch.where(gt_valid[None, :], iou2,
                           torch.full_like(iou2, -torch.inf))
        gi = torch.argmax(iou2, dim=1)
        viou = voxel_iou(det_voxels, gt_voxels[gi])
        rot = rotation_error_deg(euler_to_rotmat(rotations),
                                 euler_to_rotmat(gt_rotations[gi]))
        loc = location_error(translations, gt_locations[gi])
        return viou, rot, loc

    # ------------------------------------------------------------------
    @torch.no_grad()
    def export_frame(self, sample: DetectionSample, out_path: Optional[str],
                     draws: Optional[torch.Tensor] = None,
                     oracle: bool = False, dets: Optional[Detections] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, list]:
        """Run detector + pose on one host frame; optionally write the .h5.

        oracle=True substitutes ground truth for the network outputs (GT
        boxes, classes, masks, NOCS patches and voxels): an upper-bound run
        of pose, export and tracking without a trained detector.  `dets`
        supplies precomputed Detections (leading dim 1), so an eval loop
        shares one batched prediction pass.  draws (I, iters, S) are the
        RANSAC draws; when None they are made with `generator` (on its
        device) and moved to the exporter's.
        Returns per-class metric lists {"voxel_iou", "rot_err", "loc_err",
        "classes"}."""
        cam = self.cfg.camera
        f, b = self.dtype, torch.bool
        boxes = self._t(sample.boxes)
        valid = self._t(sample.valid, b)
        gt_voxels = self._t(sample.voxels)
        masks = self._t(sample.masks)
        depth = self._t(sample.depth)
        campose = self._t(sample.campose)
        boxes3d = self._t(sample.boxes3d)
        if dets is None:
            dets = (self._oracle_detections(sample, boxes, valid, masks,
                                            gt_voxels) if oracle
                    else self.predict(np.asarray(sample.image)[None]))
        if draws is None:
            p = self.cfg.pose
            draws = make_draws(
                (dets.boxes.shape[1], p.ransac_iters, p.ransac_sample_size),
                generator, None if generator is None else generator.device)
        draws = torch.as_tensor(draws).to(self.device)

        # GT 3D boxes cropped to the visible extent
        # (`inference_detector.py:86-119`).
        cropped = crop_gt_box3d(depth, campose, self.intrinsics, boxes3d,
                                boxes, masks[:, :cam.height, :cam.width])
        frame = postprocess_frame(
            dets.boxes[0], dets.scores[0], dets.classes[0], dets.valid[0],
            dets.masks[0], dets.voxels[0], dets.nocs[0], boxes, valid,
            depth, campose, self.intrinsics, cropped, self.cfg, True,
            draws)
        viou, rot_e, loc_e = self._metrics(
            dets.boxes[0], dets.voxels[0], frame.rotations,
            frame.translations, boxes, valid, gt_voxels,
            self._t(sample.rotations), self._t(sample.locations))
        # Everything the host needs arrives in one copy.
        (keep, classes, objectness, voxels, rotations, translations, scales,
         pred_boxes, cropped, viou, rot_e, loc_e, v0, s0) = to_host(
            [frame.valid, frame.classes, frame.objectness, frame.voxels,
             frame.rotations, frame.translations, frame.scales,
             frame.pred_boxes, cropped, viou, rot_e, loc_e, dets.valid[0],
             dets.scores[0]], f)

        keep = keep.astype(bool)
        g = int(np.asarray(sample.valid).sum())
        order = np.nonzero(keep)[0]
        # Detection-cap saturation guard: if every slot is valid and above
        # the objectness gate, real detections may have been crowded out.
        if bool(np.all(v0)) and float(np.min(s0)) > (
                self.cfg.combined.objectness_thres):
            if not self._cap_warned:
                self._cap_warned = True
                print(f"WARNING: detection buffer saturated "
                      f"({len(v0)} slots, min score {float(np.min(s0)):.2f} "
                      f"> gate {self.cfg.combined.objectness_thres}); "
                      f"raise detection.detections_per_image for eval "
                      f"parity", flush=True)

        metrics: Dict[str, list] = {"voxel_iou": [], "rot_err": [],
                                    "loc_err": [], "classes": []}
        if len(order) and g:
            for i in order:
                metrics["classes"].append(int(classes[i]))
                metrics["voxel_iou"].append(float(viou[i]))
                metrics["rot_err"].append(float(rot_e[i]))
                metrics["loc_err"].append(float(loc_e[i]))

        # The frame's ragged record: written as `out_path`, and kept as
        # `last_frame` for callers that track without files.
        self.last_frame = FrameDetections(
            classes=classes[order].astype(np.int32),
            objectness_scores=objectness[order],
            voxels=voxels[order], rotations=rotations[order],
            translations=translations[order], scales=scales[order],
            pred_boxes=pred_boxes[order],
            gt_ids=np.asarray(sample.object_ids)[:g],
            gt_boxes=cropped[:g],
            gt_voxels=np.asarray(sample.voxels, np.float32)[:g],
            gt_rotations=np.asarray(sample.rotations)[:g],
            gt_locations=np.asarray(sample.locations)[:g],
            gt_scales=np.asarray(sample.scales3d)[:g],
            gt_compl_boxes=np.asarray(sample.boxes3d)[:g],
            gt_classes=np.asarray(sample.classes)[:g])
        if out_path is not None:
            write_frame_h5(out_path, self.last_frame)
        return metrics

    def _oracle_detections(self, sample, boxes, valid, masks,
                           voxels) -> Detections:
        """GT as detections (max_instances slots): each GT mask pooled over
        its own box to 28 x 28, as the detector's mask probabilities."""
        masks28 = roi_align_own_map(masks, boxes, 28)
        return Detections(
            boxes=boxes[None], scores=valid.to(self.dtype)[None],
            classes=self._t(sample.classes, torch.int64)[None],
            valid=valid[None], masks=masks28[None], voxels=voxels[None],
            nocs=self._t(sample.nocs)[None])

    # ------------------------------------------------------------------
    def export_split(self, ds: MOTFrontDataset, out_dir: str,
                     write_files: bool = True,
                     max_scenes: Optional[int] = None,
                     oracle: bool = False) -> Dict[str, float]:
        """`make_pred` (`inference_detector.py:396-492`): walk a split,
        export every frame, report per-class mean metrics."""
        generator = torch.Generator().manual_seed(self.cfg.run.seed)
        agg: Dict[str, Dict[str, list]] = {}
        for scene in ds.scenes()[:max_scenes]:
            for t, fr in enumerate(ds.load_scene(scene).frames):
                sample = compact_sample(load_frame(ds, fr,
                                                   self.cfg.detection))
                path = (os.path.join(out_dir, scene, f"{t}.h5")
                        if write_files else None)
                m = self.export_frame(sample, path, oracle=oracle,
                                      generator=generator)
                _accumulate_classwise(agg, m)
        return _summarize_classwise(agg)

    def evaluate_samples(self, samples, oracle: bool = False,
                         dets_list=None, draws_list=None
                         ) -> Dict[str, float]:
        """Per-class voxel IoU + pose rotation/location errors over
        in-memory frames: the FrontEvaluator-equivalent voxnocs eval
        (`Detection/evaluator/FrontEvaluator.py:243-550`) that
        `DetectionTrainer.evaluate` runs every eval period.  `dets_list`
        supplies per-sample precomputed Detections, `draws_list` per-sample
        RANSAC draws (else drawn from the split's generator)."""
        generator = torch.Generator().manual_seed(self.cfg.run.seed)
        agg: Dict[str, Dict[str, list]] = {}
        for i, sample in enumerate(samples):
            m = self.export_frame(
                sample, None, None if draws_list is None else draws_list[i],
                oracle=oracle, generator=generator,
                dets=None if dets_list is None else dets_list[i])
            _accumulate_classwise(agg, m)
        # Raw per-instance lists, for the histogram summaries.
        self.last_raw_metrics = agg
        return _summarize_classwise(agg)


def _accumulate_classwise(agg: Dict[str, Dict[str, list]],
                          m: Dict[str, list]) -> None:
    for cls, vi, re_, le in zip(m["classes"], m["voxel_iou"],
                                m["rot_err"], m["loc_err"]):
        name = MOTFRONT_CLASSES[cls % len(MOTFRONT_CLASSES)]
        a = agg.setdefault(name, {"voxel_iou": [], "rot_err": [],
                                  "loc_err": []})
        a["voxel_iou"].append(vi)
        a["rot_err"].append(re_)
        a["loc_err"].append(le)


def _summarize_classwise(agg: Dict[str, Dict[str, list]]
                         ) -> Dict[str, float]:
    """Mean voxel IoU + median rotation/location error per class
    (`Detection/inference/inference_utils.py:log_results` medians)."""
    out: Dict[str, float] = {}
    for name, a in agg.items():
        out[f"{name}/voxel_iou"] = float(np.mean(a["voxel_iou"]))
        out[f"{name}/rot_err_median"] = float(np.median(a["rot_err"]))
        out[f"{name}/loc_err_median"] = float(np.median(a["loc_err"]))
    return out
