"""MOTFront dataset reading: COCO jsons, 16-bit NOCS pngs, depth/campose
hdf5, binvox voxels (counterpart of `mot3d_tpu/data/motfront.py`).

Directory layout (reference `Detection/register_dataset.py:30-152`):

    <img_dir>/3D_front_mapping.csv               # category id -> name
    <img_dir>/<split>/<scene>/coco_data/coco_annotations.json
    <img_dir>/<split>/<scene>/coco_data/rgb_XXXX.png
    <img_dir>/<split>/<scene>/coco_data/nocs_XXXX.png   # 16-bit
    <img_dir>/<split>/<scene>/<frame_idx>.hdf5          # depth, campose
    <voxel_dir>/<jid>/model.binvox

Per-annotation fields: bbox (XYWH), segmentation (polygons), category_id,
id (persistent object id), jid (CAD model), 3Dscale, 3Drot (euler),
3Dloc, 3Dbbox (8x3 world corners).

Reference behaviours preserved:
  - GT location z is replaced by half the 3D-box height
    (`register_dataset.py:363-377`, add_halfheight);
  - NOCS maps are 16-bit, read BGR->RGB (`mapper_heads.py:164-170`);
  - per-instance NOCS patches are mask-cropped, background set to white,
    then min-max normalised per patch (`Detection/utils/train_utils.py:
    277-297`), which makes the target crop-dependent;
  - voxels are loaded from binvox and anisotropically rescaled by
    3Dscale/max(3Dscale) (`train_utils.py:226-275`).

`cv2` and `h5py` are imported inside the functions that read files, so
importing this module needs neither.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from mot3d_tpu_torch.data.binvox import read_binvox, rescale_voxel


def read_csv_mapping(path: str) -> Dict[int, str]:
    """category id -> name from 3D_front_mapping.csv
    (`Utility/analyse_datset.py:47-62` semantics)."""
    out = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out[int(row["id"])] = row["name"]
    return out


def polygons_to_mask(polys: List[List[float]], height: int,
                     width: int) -> np.ndarray:
    """Polygon segmentation -> binary mask (replaces detectron2
    GenericMask)."""
    import cv2
    mask = np.zeros((height, width), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polys if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask.astype(bool)


def load_nocs_png(path: str) -> np.ndarray:
    """16-bit NOCS png -> (H, W, 3) float32 RGB in [0, 65535]."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return np.ascontiguousarray(img[:, :, :3][:, :, ::-1]).astype(np.float32)


def load_rgb_png(path: str) -> np.ndarray:
    """8-bit rgb png -> (H, W, 3) float32 RGB."""
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return np.ascontiguousarray(img[:, :, ::-1]).astype(np.float32)


def load_depth_campose(path: str):
    """Frame hdf5 -> (depth (H, W) float32, campose (4, 4) float32)."""
    import h5py
    with h5py.File(path, "r") as f:
        depth = np.array(f["depth"], np.float32)
        campose = np.array(f["campose"], np.float32)
    return depth, campose


def crop_normalise_nocs(nocs_img: np.ndarray, mask: np.ndarray,
                        box_xyxy: np.ndarray,
                        color_depth_max: float = 65535.0) -> np.ndarray:
    """Mask-crop a NOCS patch; background -> white; min-max normalise.

    Mirrors `crop_segmask` (`Detection/utils/train_utils.py:277-297`)
    including the per-patch normalisation quirk."""
    crop = nocs_img * mask[:, :, None]
    crop = np.where(crop == 0, color_depth_max, crop)
    x0, y0, x1, y1 = (int(v) for v in box_xyxy)
    patch = crop[y0:y1, x0:x1, :]
    rng = patch.max() - patch.min()
    if rng != 0:
        patch = (patch - patch.min()) / rng
    else:
        patch = patch / color_depth_max
    return patch.astype(np.float32)


def add_halfheight(location: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Replace location z by half the 3D-box height
    (`register_dataset.py:363-377`)."""
    loc = np.asarray(location, np.float64).copy()
    z = np.asarray(box)[:, -1]
    loc[-1] = abs(z.max() - z.min()) / 2
    return loc


class FrameAnnotation(NamedTuple):
    box_xywh: np.ndarray     # (4,)
    segmentation: list       # polygons
    category: int            # 0-based contiguous id
    object_id: int
    jid: str
    scale3d: np.ndarray      # (3,)
    rotation3d: np.ndarray   # (3,) euler
    location3d: np.ndarray   # (3,) half-height adjusted
    box3d: np.ndarray        # (8, 3)


class FrameRecord(NamedTuple):
    rgb_path: str
    nocs_path: str
    hdf5_path: str
    height: int
    width: int
    annotations: List[FrameAnnotation]


class MOTFrontScene(NamedTuple):
    name: str
    frames: List[FrameRecord]


def parse_annotation(a: dict, category: int) -> FrameAnnotation:
    """One COCO annotation dict of a MOTFront json -> FrameAnnotation, with
    its contiguous category id."""
    return FrameAnnotation(
        box_xywh=np.asarray(a["bbox"], np.float32),
        segmentation=a["segmentation"],
        category=category,
        object_id=int(a["id"]),
        jid=a.get("jid", ""),
        scale3d=np.asarray(a["3Dscale"], np.float32),
        rotation3d=np.asarray(a["3Drot"], np.float32),
        location3d=add_halfheight(np.asarray(a["3Dloc"], np.float32),
                                  a["3Dbbox"]),
        box3d=np.asarray(a["3Dbbox"], np.float32))


class MOTFrontDataset:
    """Scans a MOTFront split directory into per-scene frame records.

    Category ids are remapped to a contiguous 0-based range in first-seen
    order, as `RegisterDataset` does (`register_dataset.py:100-106`).
    Without `voxel_dir` the conventional sibling `<img_dir>/voxels` is used
    when it exists."""

    def __init__(self, img_dir: str, split: str,
                 voxel_dir: Optional[str] = None):
        self.img_dir = img_dir
        self.split_dir = os.path.join(img_dir, split)
        if voxel_dir is None:
            cand = os.path.join(img_dir, "voxels")
            voxel_dir = cand if os.path.isdir(cand) else None
        self.voxel_dir = voxel_dir
        mapping_file = os.path.join(img_dir, "3D_front_mapping.csv")
        self.cat_names = (read_csv_mapping(mapping_file)
                          if os.path.exists(mapping_file) else {})
        self.mapping_list: List[int] = []
        self.name_list: List[str] = []

    def scenes(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.split_dir)
            if os.path.isdir(os.path.join(self.split_dir, d)))

    def _contiguous_id(self, cat_id: int) -> int:
        if cat_id not in self.mapping_list:
            self.mapping_list.append(cat_id)
            name = self.cat_names.get(cat_id, str(cat_id))
            if name not in self.name_list:
                self.name_list.append(name)
        return self.mapping_list.index(cat_id)

    def load_scene(self, scene: str) -> MOTFrontScene:
        base = os.path.join(self.split_dir, scene)
        with open(os.path.join(base, "coco_data",
                               "coco_annotations.json")) as f:
            coco = json.load(f)
        by_image: Dict[int, list] = {}
        for anno in coco["annotations"]:
            by_image.setdefault(anno["image_id"], []).append(anno)

        frames = []
        for idx, img in enumerate(coco["images"]):
            annos = [parse_annotation(a,
                                      self._contiguous_id(a["category_id"]))
                     for a in by_image.get(img["id"], [])]
            rgb = os.path.join(base, "coco_data", img["file_name"])
            frames.append(FrameRecord(
                rgb_path=rgb, nocs_path=rgb.replace("rgb", "nocs"),
                hdf5_path=os.path.join(base, f"{idx}.hdf5"),
                height=img["height"], width=img["width"],
                annotations=annos))
        return MOTFrontScene(scene, frames)

    def load_voxel(self, jid: str, scale: np.ndarray) -> np.ndarray:
        """CAD occupancy grid, rescaled (`train_utils.py:226-245`)."""
        path = os.path.join(self.voxel_dir, jid, "model.binvox")
        grid = read_binvox(path).data.astype(np.int64)
        return rescale_voxel(grid, np.asarray(scale))

    def dataset_info(self) -> dict:
        """Split statistics: scene/image/annotation counts, class histogram,
        scenes with missing files (`Utility/analyse_datset.py:6-45`,
        get_dataset_info, reporting instead of deleting bad folders)."""
        info = {"num_scenes": 0, "num_images": 0, "num_annotations": 0,
                "class_counts": {}, "bad_scenes": []}
        for scene in self.scenes():
            try:
                rec = self.load_scene(scene)
            except (OSError, KeyError, ValueError) as e:
                info["bad_scenes"].append((scene, str(e)))
                continue
            info["num_scenes"] += 1
            info["num_images"] += len(rec.frames)
            for fr in rec.frames:
                info["num_annotations"] += len(fr.annotations)
                for a in fr.annotations:
                    name = (self.name_list[a.category]
                            if a.category < len(self.name_list)
                            else str(a.category))
                    info["class_counts"][name] = (
                        info["class_counts"].get(name, 0) + 1)
                if not os.path.exists(fr.hdf5_path):
                    info["bad_scenes"].append((scene, "missing hdf5"))
        return info
