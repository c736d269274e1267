"""Write synthetic scenes in the exact MOTFront on-disk format (a copy of
`mot3d_tpu/data/fixtures.py:write_motfront_fixture`; the same seed writes
the same scenes).

Produces the directory tree the reference consumes
(`Detection/register_dataset.py:30-152`, `Detection/data/mapper_heads.py`):

    <root>/3D_front_mapping.csv
    <root>/<split>/<scene>/coco_data/coco_annotations.json
    <root>/<split>/<scene>/coco_data/rgb_XXXX.png      (8-bit)
    <root>/<split>/<scene>/coco_data/nocs_XXXX.png     (16-bit)
    <root>/<split>/<scene>/<idx>.hdf5                  (depth, campose)
    <voxel_root>/<jid>/model.binvox

so the reader, the trainers and the exporter run on the real parsing path.
`render_motfront_scenes` draws the scenes in memory; `write_motfront_fixture`
writes them (with `cv2` and `h5py`, imported then); `fixture_samples` turns
rendered scenes into the DetectionSamples `load_frame` would read back from
the written files, without any file (and without `h5py`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple

import numpy as np

from mot3d_tpu_torch.config import (MOTFRONT_CLASSES, CameraConfig,
                                    DetectionConfig)
from mot3d_tpu_torch.data.binvox import rescale_voxel, write_binvox


def _project(pts_cam, cam: CameraConfig):
    x, y, z = pts_cam[:, 0], -pts_cam[:, 1], -pts_cam[:, 2]
    u = x / z * cam.fx + cam.cx
    v = y / z * cam.fy + cam.cy
    return u, v, z


# NOCS half-extent of the fixture cube: faces sit at nocs 0.02 / 0.98
# (matching the 32^3 binvox whose occupied region is voxels 6..26).
_BOX_H = 0.48


def _pixel_rays(cam: CameraConfig) -> np.ndarray:
    """(H, W, 3) camera-space ray directions scaled so that the point at
    depth t along a ray is t * dir (depth = the value stored in the
    depth png, i.e. -Z_cam under `_project`'s convention)."""
    dx = (np.arange(cam.width) - cam.cx) / cam.fx
    dy = -(np.arange(cam.height) - cam.cy) / cam.fy
    d = np.empty((cam.height, cam.width, 3), np.float64)
    d[:, :, 0] = dx[None, :]
    d[:, :, 1] = dy[:, None]
    d[:, :, 2] = -1.0
    return d


def _raycast_box(d_cam: np.ndarray, campose: np.ndarray, ob: dict):
    """Exact per-pixel ray / oriented-box intersection.

    Returns (hit (H, W) bool, t0 (H, W) depth, nocs (H, W, 3)) for the
    fixture cube `ob` — dense and analytically exact, unlike the former
    60k-point scatter whose holes and point-rounding made cross-frame
    NOCS targets self-inconsistent by 0.2175 (PARITY.md); that noise
    capped learned-NOCS pose quality (round-4 study: 127 deg rotation
    error vs the oracle's 2-7 deg)."""
    cy, sy = np.cos(ob["yaw"]), np.sin(ob["yaw"])
    R = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float64)
    extent = 2.0 * ob["scale"] * np.asarray(ob["half"], np.float64)
    # Ray in the box's NOCS-centred frame: q(t) = q0 + t * dq.
    q0 = R.T @ (campose[:3, 3] - ob["loc"]) / extent
    dq = (d_cam @ (R.T @ campose[:3, :3]).T) / extent
    with np.errstate(divide="ignore", invalid="ignore"):
        t_a = (-_BOX_H - q0) / dq
        t_b = (_BOX_H - q0) / dq
    t_lo, t_hi = np.minimum(t_a, t_b), np.maximum(t_a, t_b)
    par = np.abs(dq) < 1e-12                 # ray parallel to a slab pair
    inside = np.abs(q0) <= _BOX_H
    t_lo = np.where(par, np.where(inside, -np.inf, np.inf), t_lo)
    t_hi = np.where(par, np.where(inside, np.inf, -np.inf), t_hi)
    t0 = t_lo.max(-1)
    hit = (t_hi.min(-1) >= t0) & (t0 > 0.05)
    nocs = np.clip(q0 + t0[..., None] * dq + 0.5, 0.0, 1.0)
    return hit, t0, nocs


class RenderedScene(NamedTuple):
    """One fixture scene in memory: the COCO json's content, per-frame
    images (rgb uint8, nocs uint16, depth float32, campose float64) and the
    voxel grid of each CAD model id."""

    name: str
    coco: dict
    frames: List[tuple]
    voxels: Dict[str, np.ndarray]


def render_motfront_scenes(num_scenes: int = 1, num_frames: int = 3,
                           num_objects: int = 2, seed: int = 0,
                           cam: CameraConfig = CameraConfig(),
                           camera_pan: float = 0.2,
                           max_yaw: float = np.pi,
                           half_range: tuple = (0.25, 0.45),
                           scale_range: tuple = (0.8, 1.3),
                           camera_dist: float = 3.5,
                           area: float = 1.0) -> List[RenderedScene]:
    """Boxes/cuboids moving in world space under a panning camera, drawn
    exactly as the JAX package's `write_motfront_fixture` draws them (the
    same seed gives the same scenes).

    half_range/scale_range/camera_dist/area control apparent object size.
    The defaults render furniture of ~50-90 px sqrt-area, between the
    detector's factor-2 anchor scales, so best-anchor IoU is mostly < 0.7
    and a from-scratch RPN gives the 0.75-IoU ROI sampler almost no
    positives.  For protocol-quality training at fixture scale pass larger
    furniture (e.g. half_range=(0.35, 0.6), camera_dist=2.6), matching real
    MOTFront's frame-filling beds and sofas."""
    rng = np.random.default_rng(seed)
    H, W = cam.height, cam.width
    out = []
    for s in range(num_scenes):
        scene = f"scene_{seed}_{s:04d}"
        voxels = {}
        # Objects: NOCS cubes with fixed world pose + per-frame camera
        # motion.
        objs = []
        for k in range(num_objects):
            jid = f"jid_{seed}_{s}_{k}"
            grid = np.zeros((32, 32, 32), bool)
            grid[6:26, 6:26, 6:26] = True
            voxels[jid] = grid
            scale = float(rng.uniform(*scale_range))
            half = rng.uniform(half_range[0], half_range[1], 3)
            # Objects sit on the floor (z = 0), so add_halfheight's z is
            # the z-centre; x/y are rejection-sampled so boxes do not
            # interpenetrate.
            for _ in range(100):
                loc = np.array([rng.uniform(-area, area),
                                rng.uniform(-area, area),
                                half[2] * scale])
                r = scale * float(np.hypot(half[0], half[1]))
                if all(np.hypot(*(loc[:2] - o["loc"][:2])) >
                       r + o["scale"] * float(np.hypot(o["half"][0],
                                                       o["half"][1]))
                       for o in objs):
                    break
            objs.append({
                "jid": jid,
                "cat": int(rng.integers(1, len(MOTFRONT_CLASSES) + 1)),
                "obj_id": 100 + k,
                "scale": scale,
                "yaw": float(rng.uniform(-max_yaw, max_yaw)) if max_yaw
                else 0.0,
                "loc": loc,
                "half": half,
            })

        images, annos, frames = [], [], []
        ann_id = 0
        d_cam = _pixel_rays(cam)
        for t in range(num_frames):
            # Camera: world z-up, looking along -Z in camera space.
            campose = np.eye(4, dtype=np.float64)
            campose[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]],
                                       np.float64)
            campose[:3, 3] = [camera_pan * t, -camera_dist, 1.2]

            depth = np.zeros((H, W), np.float32)
            zbuf = np.full((H, W), np.inf, np.float32)
            nocs16 = np.zeros((H, W, 3), np.uint16)
            rgb = np.full((H, W, 3), 60, np.uint8)
            frame_annos = []
            for ob in objs:
                # Dense analytic raster (see _raycast_box); the per-object
                # hit mask is amodal (pre-occlusion).
                hit, t0, nocs = _raycast_box(d_cam, campose, ob)
                closer = hit & (t0 < zbuf)
                zbuf[closer] = t0[closer]
                depth[closer] = t0[closer]
                nocs16[closer] = (nocs[closer] * 65535).astype(np.uint16)
                # RGB = class tint + NOCS-correlated texture, so appearance
                # encodes surface geometry as in real MOTFront renders.
                cat = ob["cat"]
                tint = np.array([(50 + cat * 37) % 200 + 30,
                                 (80 + cat * 59) % 200 + 30,
                                 (110 + cat * 83) % 200 + 30], np.float64)
                rgb[closer] = np.clip(
                    0.35 * tint + 0.65 * 255.0 * nocs[closer],
                    0, 255).astype(np.uint8)

                if hit.sum() < 20:
                    continue
                ys, xs = np.nonzero(hit)
                x0, y0 = int(xs.min()), int(ys.min())
                x1, y1 = int(xs.max()) + 1, int(ys.max()) + 1
                seg = [[float(x0), float(y0), float(x1), float(y0),
                        float(x1), float(y1), float(x0), float(y1)]]
                cy, sy = np.cos(ob["yaw"]), np.sin(ob["yaw"])
                R = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
                corners_local = np.array(
                    [[sx, sy_, sz] for sx in (-1, 1) for sy_ in (-1, 1)
                     for sz in (-1, 1)], np.float64) * (ob["scale"]
                                                        * ob["half"])
                corners = corners_local @ R.T + ob["loc"]
                frame_annos.append({
                    "id": ob["obj_id"], "image_id": t,
                    "category_id": ob["cat"], "jid": ob["jid"],
                    "bbox": [float(x0), float(y0), float(x1 - x0),
                             float(y1 - y0)],
                    "segmentation": seg,
                    "3Dscale": [ob["scale"]] * 3,
                    "3Drot": [0.0, 0.0, ob["yaw"]],
                    "3Dloc": [float(c) for c in ob["loc"]],
                    "3Dbbox": corners.tolist(),
                    "area": float((x1 - x0) * (y1 - y0)),
                    "iscrowd": 0,
                })
            images.append({"id": t, "file_name": f"rgb_{t:04d}.png",
                           "height": H, "width": W})
            frames.append((rgb, nocs16, depth, campose))
            for a in frame_annos:
                a = dict(a)
                a["id_anno"] = ann_id
                ann_id += 1
                annos.append(a)

        coco = {
            "images": images,
            "annotations": annos,
            "categories": [
                {"id": i + 1, "name": n, "supercategory": "furniture"}
                for i, n in enumerate(MOTFRONT_CLASSES)],
        }
        out.append(RenderedScene(scene, coco, frames, voxels))
    return out


def write_motfront_fixture(root: str, split: str = "train",
                           num_scenes: int = 1, num_frames: int = 3,
                           num_objects: int = 2, seed: int = 0,
                           voxel_root: str | None = None,
                           cam: CameraConfig = CameraConfig(),
                           **render) -> List[str]:
    """Render scenes (`render_motfront_scenes`; `render` takes its size
    arguments) and write them under `root`; returns the scene names."""
    import cv2
    import h5py

    voxel_root = voxel_root or os.path.join(root, "voxels")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "3D_front_mapping.csv"), "w") as f:
        f.write("id,name\n")
        for i, name in enumerate(MOTFRONT_CLASSES):
            f.write(f"{i + 1},{name}\n")
    scenes = render_motfront_scenes(num_scenes, num_frames, num_objects,
                                    seed, cam, **render)
    for sc in scenes:
        for jid, grid in sc.voxels.items():
            os.makedirs(os.path.join(voxel_root, jid), exist_ok=True)
            write_binvox(os.path.join(voxel_root, jid, "model.binvox"), grid)
        base = os.path.join(root, split, sc.name)
        coco_dir = os.path.join(base, "coco_data")
        os.makedirs(coco_dir, exist_ok=True)
        for t, (rgb, nocs16, depth, campose) in enumerate(sc.frames):
            cv2.imwrite(os.path.join(coco_dir, f"rgb_{t:04d}.png"),
                        rgb[:, :, ::-1])
            cv2.imwrite(os.path.join(coco_dir, f"nocs_{t:04d}.png"),
                        nocs16[:, :, ::-1])
            with h5py.File(os.path.join(base, f"{t}.hdf5"), "w") as hf:
                hf.create_dataset("depth", data=depth)
                hf.create_dataset("campose", data=campose)
        with open(os.path.join(coco_dir, "coco_annotations.json"), "w") as f:
            json.dump(sc.coco, f)
    return [sc.name for sc in scenes]


def fixture_samples(scenes: List[RenderedScene], cfg: DetectionConfig,
                    category_ids: List[int] | None = None,
                    nocs_patch_size: int = 28) -> List[list]:
    """Rendered scenes -> per scene, the DetectionSamples that
    `MOTFrontDataset` + `load_frame` read from the written fixture (the
    PNG round trip is lossless and the depth is float32 either way), with
    no file.  `category_ids` is the dataset's first-seen category list,
    shared and extended across calls as one `MOTFrontDataset` shares it
    across the scenes it loads (pass the same list for every scene of one
    split, in sorted scene order)."""
    from mot3d_tpu_torch.data.detection_loader import frame_sample
    from mot3d_tpu_torch.data.motfront import parse_annotation

    mapping = [] if category_ids is None else category_ids
    out = []
    for sc in sorted(scenes, key=lambda s: s.name):
        by_image: Dict[int, list] = {}
        for a in sc.coco["annotations"]:
            by_image.setdefault(a["image_id"], []).append(a)
        samples = []
        for img, (rgb, nocs16, depth, campose) in zip(sc.coco["images"],
                                                      sc.frames):
            annos = []
            for a in by_image.get(img["id"], []):
                if a["category_id"] not in mapping:
                    mapping.append(a["category_id"])
                annos.append(parse_annotation(
                    a, mapping.index(a["category_id"])))
            samples.append(frame_sample(
                rgb.astype(np.float32), nocs16.astype(np.float32), depth,
                campose.astype(np.float32), annos, cfg,
                lambda jid, scale, v=sc.voxels: rescale_voxel(
                    v[jid].astype(np.int64), np.asarray(scale)),
                nocs_patch_size))
        out.append(samples)
    return out


# TUM RGB-D freiburg1's published colour intrinsics (fx fy cx cy, 640 x 480).
TUM_FR1_INTRINSICS = (517.3, 516.5, 318.6, 255.3)


def write_office_fixture(root: str, num_scenes: int = 2,
                         num_frames: int = 25, seed: int = 0,
                         hw=(480, 640), intrinsics=TUM_FR1_INTRINSICS,
                         person_scenes=(0,), depth_scale: float = 10.0
                         ) -> List[str]:
    """Write synthetic scenes in the office reader's on-disk format
    (`data/office.py`): `rgb/*.png`, 8-bit `depth/*.png` (the reader takes
    the first channel as the depth), `calibration.txt` ("fx fy cx cy") and,
    for the scenes in `person_scenes`, `denseposes/*.png` person masks.

    Each scene is a room (a depth that tilts from floor to wall) with four
    box-shaped objects nearer the camera, drawn in flat colours and
    panning slowly to the left; depths are written in units of
    1 / depth_scale (decimetres by default), rounded to 8 bits.  Returns
    the scene names."""
    import cv2
    h, w = hw
    rng = np.random.default_rng(seed)
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    names = []
    for s in range(num_scenes):
        name = f"scene{s:02d}"
        base = os.path.join(root, name)
        subdirs = ("rgb", "depth") + (("denseposes",) if s in person_scenes
                                      else ())
        for sub in subdirs:
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        with open(os.path.join(base, "calibration.txt"), "w") as f:
            f.write(" ".join(f"{v}" for v in intrinsics) + "\n")
        objs = [(rng.uniform(0.06, 0.7) * w, rng.uniform(0.08, 0.6) * h,
                 rng.uniform(0.12, 0.28) * w, rng.uniform(0.16, 0.33) * h,
                 rng.uniform(1.5, 3.0)) for _ in range(4)]
        for t in range(num_frames):
            shift = 0.005 * w * t
            d = 4.0 - 1.5 * vv / h + 0.002 * uu * 640 / w
            img = rng.uniform(40, 90, (h, w, 3))
            for j, (x, y, bw, bh, z) in enumerate(objs):
                x0, y0 = max(int(x - shift), 0), int(y)
                x1, y1 = int(x - shift + bw), int(y + bh)
                if x1 <= 0:
                    continue
                d[y0:y1, x0:x1] = z + 0.001 * (uu[y0:y1, x0:x1] - x0)
                img[y0:y1, x0:x1] = (60 + 40 * j, 200 - 30 * j, 90 + 25 * j)
            depth8 = np.clip(np.round(d * depth_scale), 0, 255).astype(
                np.uint8)
            fname = f"{t:04d}.png"
            cv2.imwrite(os.path.join(base, "rgb", fname),
                        img[:, :, ::-1].astype(np.uint8))
            cv2.imwrite(os.path.join(base, "depth", fname),
                        np.repeat(depth8[:, :, None], 3, -1))
            if s in person_scenes:
                person = np.zeros((h, w), np.uint8)
                person[h // 3:, int(0.85 * w):] = 1 + t % 3
                cv2.imwrite(os.path.join(base, "denseposes", fname),
                            np.repeat(person[:, :, None], 3, -1))
        names.append(name)
    return names
