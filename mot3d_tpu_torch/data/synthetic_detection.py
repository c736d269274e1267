"""Synthetic detection scenes: images with textured rectangles + full padded
ground truth (boxes, masks, voxels, NOCS patches) for tests and the smoke
run (the port's copy of `mot3d_tpu/data/synthetic_detection.py`; the same
seed draws the same scene).

The NOCS patch of each object is a linear coordinate ramp over the box (the
exact pattern a NOCS map has for an axis-aligned cuboid face), so the NOCS
loss has a learnable, geometrically meaningful target.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mot3d_tpu_torch.config import DetectionConfig


class DetectionScene(NamedTuple):
    images: np.ndarray     # (B, pad_H, pad_W, 3) float32 0..255
    boxes: np.ndarray      # (B, M, 4) XYXY
    classes: np.ndarray    # (B, M)
    valid: np.ndarray      # (B, M)
    masks: np.ndarray      # (B, M, pad_H, pad_W)
    voxels: np.ndarray     # (B, M, 32, 32, 32)
    nocs: np.ndarray       # (B, M, P, P, 3)


def nocs_ramp(nocs_patch: int = 28) -> np.ndarray:
    """(P, P, 3) NOCS patch: x and y ramp from 0.1 to 0.9 over the box,
    z is 0.5."""
    ramp = np.linspace(0.1, 0.9, nocs_patch, dtype=np.float32)
    return np.stack(
        [np.tile(ramp, (nocs_patch, 1)),
         np.tile(ramp[:, None], (1, nocs_patch)),
         np.full((nocs_patch, nocs_patch), 0.5, np.float32)], axis=-1)


def class_voxels(cls: int) -> np.ndarray:
    """(32, 32, 32) solid box whose height depends on the class."""
    g = np.zeros((32, 32, 32), np.float32)
    d = 8 + 2 * (cls % 6)
    g[4:4 + d, 4:28, 6:26] = 1.0
    return g


def synthetic_detection_scene(cfg: DetectionConfig, batch: int = 2,
                              num_objects: int = 3, seed: int = 0,
                              nocs_patch: int = 28) -> DetectionScene:
    rng = np.random.default_rng(seed)
    H, W = cfg.pad_height, cfg.pad_width
    M = cfg.max_instances
    K = min(num_objects, M)

    images = rng.uniform(40, 80, size=(batch, H, W, 3)).astype(np.float32)
    boxes = np.zeros((batch, M, 4), np.float32)
    classes = np.zeros((batch, M), np.int32)
    valid = np.zeros((batch, M), bool)
    masks = np.zeros((batch, M, H, W), np.float32)
    voxels = np.zeros((batch, M, 32, 32, 32), np.float32)
    nocs = np.zeros((batch, M, nocs_patch, nocs_patch, 3), np.float32)

    nocs_template = nocs_ramp(nocs_patch)

    for b in range(batch):
        for k in range(K):
            w = rng.integers(30, min(90, W // 2))
            h = rng.integers(30, min(90, H // 2))
            x0 = rng.integers(0, W - w)
            y0 = rng.integers(0, H - h)
            cls = int(rng.integers(0, cfg.num_classes))
            color = 120 + 100 * np.array([cls % 3 == 0, cls % 3 == 1,
                                          cls % 3 == 2], np.float32)
            images[b, y0:y0 + h, x0:x0 + w] = color + rng.normal(
                scale=5, size=(h, w, 3))
            boxes[b, k] = [x0, y0, x0 + w, y0 + h]
            classes[b, k] = cls
            valid[b, k] = True
            masks[b, k, y0:y0 + h, x0:x0 + w] = 1.0
            voxels[b, k] = class_voxels(cls)
            nocs[b, k] = nocs_template

    return DetectionScene(images, boxes, classes, valid, masks, voxels, nocs)
