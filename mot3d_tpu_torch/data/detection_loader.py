"""MOTFront -> padded detection training batches (counterpart of
`mot3d_tpu/data/detection_loader.py`).

The reference's per-image mapper (`Detection/data/mapper_heads.py:31-307`,
VoxNocsMapper) does png/hdf5/binvox I/O and per-annotation crops inside
the torch DataLoader; here the same work produces fixed-shape padded numpy
samples (GT, image, depth, campose), batched by a background thread.
`data/prefetch.py:device_prefetch` moves them to the device.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple

import numpy as np

from mot3d_tpu_torch.config import DetectionConfig
from mot3d_tpu_torch.data.motfront import (MOTFrontDataset,
                                           crop_normalise_nocs,
                                           load_depth_campose, load_nocs_png,
                                           load_rgb_png, polygons_to_mask)
from mot3d_tpu_torch.data.prefetch import background_iter
from mot3d_tpu_torch.geometry.transforms import sort_bbox_np


class DetectionSample(NamedTuple):
    """One padded frame (numpy, host); a batch has a leading axis."""

    image: np.ndarray        # (pad_H, pad_W, 3) float32 RGB
    depth: np.ndarray        # (H, W)
    campose: np.ndarray      # (4, 4)
    boxes: np.ndarray        # (M, 4) XYXY
    classes: np.ndarray      # (M,)
    valid: np.ndarray        # (M,)
    masks: np.ndarray        # (M, pad_H, pad_W)
    voxels: np.ndarray       # (M, 32, 32, 32)
    nocs: np.ndarray         # (M, P, P, 3)
    boxes3d: np.ndarray      # (M, 8, 3) world corners
    object_ids: np.ndarray   # (M,)
    locations: np.ndarray    # (M, 3)
    rotations: np.ndarray    # (M, 3)
    scales3d: np.ndarray     # (M,)


def _resize_patch(patch: np.ndarray, size: int) -> np.ndarray:
    import cv2
    if patch.size == 0:
        return np.zeros((size, size, 3), np.float32)
    return cv2.resize(patch, (size, size), interpolation=cv2.INTER_LINEAR)


def frame_sample(img: np.ndarray, nocs_img: np.ndarray, depth: np.ndarray,
                 campose: np.ndarray, annotations, cfg: DetectionConfig,
                 load_voxel=None, nocs_patch_size: int = 28
                 ) -> DetectionSample:
    """Pad one decoded frame: img (H, W, 3) float32 RGB, nocs_img (H, W, 3)
    float32 in [0, 65535], depth (H, W), campose (4, 4), FrameAnnotations;
    `load_voxel(jid, scale3d)` gives an annotation's grid (voxels stay 0
    without it)."""
    m = cfg.max_instances
    h, w = img.shape[:2]
    pad_img = np.zeros((cfg.pad_height, cfg.pad_width, 3), np.float32)
    pad_img[:h, :w] = img
    out = DetectionSample(
        image=pad_img, depth=depth, campose=campose,
        boxes=np.zeros((m, 4), np.float32),
        classes=np.zeros((m,), np.int32),
        valid=np.zeros((m,), bool),
        masks=np.zeros((m, cfg.pad_height, cfg.pad_width), np.float32),
        voxels=np.zeros((m, 32, 32, 32), np.float32),
        nocs=np.zeros((m, nocs_patch_size, nocs_patch_size, 3), np.float32),
        boxes3d=np.zeros((m, 8, 3), np.float32),
        object_ids=np.full((m,), -1, np.int32),
        locations=np.zeros((m, 3), np.float32),
        rotations=np.zeros((m, 3), np.float32),
        scales3d=np.ones((m,), np.float32),
    )
    for i, a in enumerate(annotations[:m]):
        x, y, bw, bh = a.box_xywh
        box = np.array([x, y, x + bw, y + bh], np.float32)
        mask = polygons_to_mask(a.segmentation, h, w)
        patch = crop_normalise_nocs(nocs_img, mask, box)
        out.boxes[i] = box
        out.classes[i] = a.category
        out.valid[i] = True
        out.masks[i, :h, :w] = mask
        if load_voxel is not None:
            out.voxels[i] = load_voxel(a.jid, a.scale3d)
        out.nocs[i] = _resize_patch(patch, nocs_patch_size)
        # Canonical corner order: box3d_iou reads corners by index.
        out.boxes3d[i] = sort_bbox_np(a.box3d)
        out.object_ids[i] = a.object_id
        out.locations[i] = a.location3d
        out.rotations[i] = a.rotation3d
        out.scales3d[i] = float(np.asarray(a.scale3d).max())
    return out


def load_frame(ds: MOTFrontDataset, frame, cfg: DetectionConfig,
               nocs_patch_size: int = 28,
               load_voxels: bool = True) -> DetectionSample:
    """Load and pad one frame record (see MOTFrontDataset.load_scene)."""
    depth, campose = load_depth_campose(frame.hdf5_path)
    return frame_sample(
        load_rgb_png(frame.rgb_path), load_nocs_png(frame.nocs_path), depth,
        campose, frame.annotations, cfg,
        ds.load_voxel if load_voxels and ds.voxel_dir else None,
        nocs_patch_size)


def stack_samples(samples: List[DetectionSample]) -> DetectionSample:
    return DetectionSample(*[np.stack([getattr(s, f) for s in samples])
                             for f in DetectionSample._fields])


def compact_sample(s: DetectionSample) -> DetectionSample:
    """Narrow the heavy fields for the host->device copy: uint8 image, bool
    masks and voxels (values exactly representable: pixels are whole
    numbers, masks and voxels 0/1).  A full-size f32 batch is ~4x the
    bytes; the train step widens back to f32 on the device."""
    return s._replace(image=s.image.astype(np.uint8),
                      masks=s.masks.astype(bool),
                      voxels=s.voxels.astype(bool))


def iterate_detection_batches(ds: MOTFrontDataset, cfg: DetectionConfig,
                              batch_size: int, shuffle: bool = True,
                              seed: int = 0, epochs: int = 1,
                              prefetch: int = 2,
                              cache_samples: int = 0
                              ) -> Iterator[DetectionSample]:
    """Batches over all frames of a split, loaded by a background thread
    `prefetch` batches ahead; a seeded numpy permutation per epoch when
    `shuffle`.  cache_samples > 0 keeps up to that many decoded frames in
    memory, so later epochs skip png/hdf5/binvox decoding.  A loading error
    is raised in the consumer; closing the iterator stops the thread."""
    scenes = ds.scenes()
    index = [(s, t) for s in scenes
             for t in range(len(ds.load_scene(s).frames))]
    rng = np.random.default_rng(seed)
    cache: dict = {}

    def load(k):
        if k in cache:
            return cache[k]
        scene, t = index[k]
        sample = load_frame(ds, ds.load_scene(scene).frames[t], cfg)
        if len(cache) < cache_samples:
            cache[k] = sample
        return sample

    def produce(emit):
        for _ in range(epochs):
            order = (rng.permutation(len(index)) if shuffle
                     else range(len(index)))
            batch: List[DetectionSample] = []
            for k in order:
                batch.append(load(int(k)))
                if len(batch) == batch_size:
                    if not emit(stack_samples(batch)):
                        return
                    batch = []

    return background_iter(produce, prefetch)
