"""Office (real-world TUM RGB-D) dataset and inference pipeline
(counterpart of `mot3d_tpu/data/office.py`).

Mirrors `Detection/data/office_dataset.py:11-113` and the office inference
flow of `Detection/inference_office_dset.py:51-404`:

    <base>/<scene>/rgb/<img>.png
    <base>/<scene>/depth/<img>.png        (8-bit, first channel)
    <base>/<scene>/denseposes/<img>.png   (person mask; optional)
    <base>/<scene>/calibration.txt        ("fx fy cx cy" on line 1)

Images are resized to the configured camera size (intrinsics scaled
alike).  There is no ground truth: poses are estimated in camera space
(`postprocess_frames` with use_gt_gate=False and an identity campose) and
tracked by the heuristic L2 tracker, or the F2F baseline associates
segment point-cloud centres.  `cv2` and scipy are imported inside the
functions that use them.
"""

from __future__ import annotations

import os
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import Config
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.geometry.umeyama import make_draws


class OfficeFrame(NamedTuple):
    rgb: np.ndarray            # (H, W, 3) float32 RGB
    depth: np.ndarray          # (H, W) float32
    person_mask: np.ndarray    # (H, W) bool, True = person
    intrinsics: np.ndarray     # (3, 3) resized intrinsics
    scene: str
    name: str


class OfficeDataset:
    def __init__(self, base_dir: str, resize_hw=(240, 320),
                 mask_person: bool = False):
        self.base_dir = base_dir
        self.resize_hw = resize_hw
        self.mask_person = mask_person
        self.scenes = sorted(
            d for d in os.listdir(base_dir)
            if os.path.isdir(os.path.join(base_dir, d)))

    def frames(self, scene: str) -> List[str]:
        return sorted(os.listdir(os.path.join(self.base_dir, scene, "rgb")))

    def load_frame(self, scene: str, name: str) -> OfficeFrame:
        import cv2
        base = os.path.join(self.base_dir, scene)
        h, w = self.resize_hw
        rgb = cv2.imread(os.path.join(base, "rgb", name))[:, :, ::-1]
        orig_h, orig_w = rgb.shape[:2]
        rgb = cv2.resize(rgb.astype(np.float32), (w, h),
                         interpolation=cv2.INTER_LINEAR)
        depth = cv2.imread(os.path.join(base, "depth", name))[:, :, 0]
        depth = cv2.resize(depth.astype(np.float32), (w, h),
                           interpolation=cv2.INTER_LINEAR)
        dp_path = os.path.join(base, "denseposes", name)
        if os.path.exists(dp_path):
            person = cv2.imread(dp_path)[:, :, 0].astype(np.float32)
            person = cv2.resize(person, (w, h),
                                interpolation=cv2.INTER_NEAREST) > 0
        else:
            person = np.zeros((h, w), bool)
        if self.mask_person:
            rgb = rgb * (~person[:, :, None])

        with open(os.path.join(base, "calibration.txt")) as f:
            fx, fy, cx, cy = (float(v) for v in f.readline().split()[:4])
        sx, sy = w / orig_w, h / orig_h
        intr = np.array([[fx * sx, 0, cx * sx], [0, fy * sy, cy * sy],
                         [0, 0, 1]], np.float32)
        return OfficeFrame(rgb, depth, person, intr, scene, name)


def frame_generator(seed: int, index: int, device) -> torch.Generator:
    """The default RANSAC generator of frame `index` of a scene: seeded
    from (run.seed, index), so a frame's draws do not depend on the
    frames before it."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, index])
                      .generate_state(1, np.uint64)[0] >> 1))
    return g


class _Clock:
    """Seconds by stage into `stage_s` (synchronising the device at each
    stage's end), or nothing when `stage_s` is None."""

    def __init__(self, stage_s: Optional[dict], device: torch.device):
        self.stage_s, self.device = stage_s, device
        self.t0 = time.perf_counter()

    def lap(self, stage: str) -> None:
        if self.stage_s is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stage_s[stage] = self.stage_s.get(stage, 0.0) + now - self.t0
        self.t0 = now


@torch.no_grad()
def office_inference(cfg: Config, model, dataset: OfficeDataset, scene: str,
                     max_frames: Optional[int] = None,
                     dist_thres: float = 0.25, tracker: str = "heuristic",
                     device=None, draws=None,
                     generator: Optional[torch.Generator] = None,
                     stage_s: Optional[dict] = None):
    """Detector -> camera-space pose (no GT gates) -> tracking, one frame
    at a time: the office variant of the combined pipeline
    (`Detection/inference_office_dset.py`, postprocess_dets_office +
    run_pose_office), with an identity campose that keeps poses in camera
    space.

    tracker:
      - "heuristic": greedy L2 matching on pose-estimated locations
        (`tracking_front.py:64-94` pred_trajectory_office);
      - "f2f": the Mask-R-CNN-only F2F baseline, association on segment
        point-cloud centres, no pose input (`postprocess_dets_office_F2F`,
        `postprocess.py:354-411`).

    `model` is a `MaskRCNN`, moved to `device` (None: the GPU, raising
    without one).  RANSAC draws: `draws` (T, I, iters, S) for the scene's
    frames, else made per frame with `generator`, else with
    `frame_generator(cfg.run.seed, t)`.  With a dict `stage_s`, the
    seconds of each stage (reader, detector, pose or centres, tracker) are
    added to it.  Returns (trajectories, per-frame detection dicts)."""
    from scipy.spatial.transform import Rotation

    from mot3d_tpu_torch.parallel.infer_step import to_host
    from mot3d_tpu_torch.pose.pipeline import paste_patch, postprocess_frames
    from mot3d_tpu_torch.tracking.f2f import F2FTracker, segment_centers
    from mot3d_tpu_torch.tracking.heuristic import HeuristicTracker

    if tracker not in ("heuristic", "f2f"):
        raise ValueError(f"unknown tracker {tracker!r}")
    device = resolve_device(device)
    model = model.to(device).eval()
    dt = torch.float32
    p = cfg.pose
    eye = torch.eye(4, dtype=dt, device=device)[None]
    no_gt2d = torch.zeros((1, 1, 4), dtype=dt, device=device)
    no_gt_valid = torch.zeros((1, 1), dtype=torch.bool, device=device)
    no_gt3d = torch.zeros((1, 1, 8, 3), dtype=dt, device=device)
    pad_h, pad_w = cfg.detection.pad_height, cfg.detection.pad_width
    clock = _Clock(stage_s, device)
    per_frame = []
    names = dataset.frames(scene)[:max_frames]
    for t, name in enumerate(names):
        fr = dataset.load_frame(scene, name)
        img = np.zeros((pad_h, pad_w, 3), np.float32)
        img[:fr.rgb.shape[0], :fr.rgb.shape[1]] = fr.rgb
        img = torch.from_numpy(img).to(device)[None]
        depth = torch.from_numpy(fr.depth).to(device)
        intr = torch.from_numpy(fr.intrinsics).to(device)
        clock.lap("reader_s")
        dets = model.predict(img)
        clock.lap("detector_s")
        frame_dets = []
        if tracker == "f2f":
            h, w = depth.shape
            full = paste_patch(dets.masks[0][..., None], dets.boxes[0],
                               (h, w))[..., 0]
            ok = dets.valid[0] & (dets.scores[0]
                                  > cfg.combined.objectness_office)
            centres, has = segment_centers(full, dets.boxes[0], ok, depth,
                                           intr)
            centres, has, classes, boxes = to_host(
                (centres, has, dets.classes[0], dets.boxes[0]))
            clock.lap("centres_s")
            for i in np.nonzero(has)[0]:
                frame_dets.append({"loc": centres[i], "cls": int(classes[i]),
                                   "box2d": boxes[i]})
        else:
            i_slots = dets.boxes.shape[1]
            if draws is not None:
                d = torch.as_tensor(draws[t], device=device)[None]
            else:
                d = make_draws((1, i_slots, p.ransac_iters,
                                p.ransac_sample_size),
                               generator if generator is not None else
                               frame_generator(cfg.run.seed, t, device),
                               device)
            out = postprocess_frames(
                dets.boxes, dets.scores, dets.classes, dets.valid,
                dets.masks, dets.voxels, dets.nocs, no_gt2d, no_gt_valid,
                depth[None], eye, intr, no_gt3d, cfg, use_gt_gate=False,
                draws=d)
            valid, euler, loc, scale, classes, voxels, boxes = to_host(
                [x[0] for x in (out.valid, out.rotations, out.translations,
                                out.scales, out.classes, out.voxels,
                                out.pred_boxes)])
            clock.lap("pose_s")
            for i in np.nonzero(valid)[0]:
                c2w = np.identity(4)
                c2w[:3, :3] = Rotation.from_euler(
                    "xyz", euler[i]).as_matrix() * float(scale[i])
                c2w[:3, 3] = loc[i]
                frame_dets.append({
                    "loc": loc[i], "euler": euler[i],
                    "scale": float(scale[i]), "cad2world": c2w,
                    "cls": int(classes[i]), "voxel": voxels[i],
                    "box": boxes[i]})
        per_frame.append(frame_dets)
    trk = (F2FTracker(dist_thres=dist_thres, seq_len=len(names))
           if tracker == "f2f"
           else HeuristicTracker(dist_thres=dist_thres, seq_len=len(names)))
    trajectories = trk.track(per_frame)
    clock.lap("tracker_s")
    return trajectories, per_frame
