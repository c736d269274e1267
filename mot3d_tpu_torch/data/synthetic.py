"""Synthetic MOTFront-like sequences (padded tensor format) for tests and
the smoke run (the port's copy of `mot3d_tpu/data/synthetic.py`; the same
seed draws the same sequence).

Generates a sequence of T frames with K moving objects: world trajectories,
per-frame "detections" = GT + noise with optional drops and spurious FPs,
per-object voxel blobs, and world-space AABB corner boxes in the canonical
ordering — everything the tracking stack consumes
(SURVEY.md §4: golden-file tests on tiny synthetic fixtures).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mot3d_tpu_torch.config import TrackingConfig


class SyntheticSequence(NamedTuple):
    # Detections (padded to (T, I)).
    det_valid: np.ndarray       # (T, I) bool
    translations: np.ndarray    # (T, I, 3)
    rotations: np.ndarray       # (T, I, 3) euler
    scales: np.ndarray          # (T, I)
    pred_boxes: np.ndarray      # (T, I, 8, 3)
    voxels: np.ndarray          # (T, I, 32, 32, 32) float {0,1}
    classes: np.ndarray         # (T, I) int32
    # Ground truth (padded to (T, G)).
    gt_valid: np.ndarray        # (T, G) bool
    gt_ids: np.ndarray          # (T, G) int32
    gt_locations: np.ndarray    # (T, G, 3)
    gt_rotations: np.ndarray    # (T, G, 3)
    gt_scales: np.ndarray       # (T, G)
    gt_boxes: np.ndarray        # (T, G, 8, 3)
    gt_classes: np.ndarray      # (T, G) int32


_SIGNS = np.array(
    [[1, 1, 1], [1, 1, -1], [-1, 1, -1], [-1, 1, 1],
     [1, -1, 1], [1, -1, -1], [-1, -1, -1], [-1, -1, 1]], np.float64)


def _corners(center, half):
    return center[None, :] + _SIGNS * half[None, :]


def _voxel_blob(rng, cls_id: int) -> np.ndarray:
    """Deterministic-ish per-class blob + noise so appearance is informative."""
    g = np.zeros((32, 32, 32), np.float32)
    c = 10 + 2 * (cls_id % 6)
    g[8:c + 8, 8:24, 10:22] = 1.0
    flip = rng.uniform(size=g.shape) < 0.02
    g[flip] = 1.0 - g[flip]
    return g


def synthetic_sequence(cfg: TrackingConfig, seed: int = 0, num_objects: int = 4,
                       noise: float = 0.02, drop_prob: float = 0.1,
                       fp_prob: float = 0.05,
                       num_gt_slots: int | None = None) -> SyntheticSequence:
    rng = np.random.default_rng(seed)
    T, I = cfg.seq_len, cfg.max_instances_per_frame
    G = num_gt_slots or I
    K = min(num_objects, G, I)

    # Object world trajectories: random start, smooth velocity.
    start = rng.uniform(-3, 3, size=(K, 3))
    start[:, 1] = rng.uniform(0.2, 1.0, size=K)
    vel = rng.uniform(-0.08, 0.08, size=(K, 3))
    half = rng.uniform(0.25, 0.6, size=(K, 3))
    cls_ids = rng.integers(0, 7, size=K)
    obj_scale = rng.uniform(0.8, 1.6, size=K)
    obj_rot = rng.uniform(-np.pi, np.pi, size=(K, 3)) * np.array([0.05, 1.0, 0.05])

    det_valid = np.zeros((T, I), bool)
    translations = np.zeros((T, I, 3), np.float32)
    rotations = np.zeros((T, I, 3), np.float32)
    scales = np.ones((T, I), np.float32)
    pred_boxes = np.zeros((T, I, 8, 3), np.float32)
    voxels = np.zeros((T, I, 32, 32, 32), np.float32)
    classes = np.zeros((T, I), np.int32)

    gt_valid = np.zeros((T, G), bool)
    gt_ids = np.full((T, G), -1, np.int32)
    gt_locations = np.zeros((T, G, 3), np.float32)
    gt_rotations = np.zeros((T, G, 3), np.float32)
    gt_scales = np.ones((T, G), np.float32)
    gt_boxes = np.zeros((T, G, 8, 3), np.float32)
    gt_classes = np.zeros((T, G), np.int32)

    blobs = [_voxel_blob(rng, int(c)) for c in cls_ids]

    for t in range(T):
        slot = 0
        for k in range(K):
            center = start[k] + vel[k] * t
            # GT slot k.
            gt_valid[t, k] = True
            gt_ids[t, k] = k
            gt_locations[t, k] = center
            gt_rotations[t, k] = obj_rot[k]
            gt_scales[t, k] = obj_scale[k]
            gt_boxes[t, k] = _corners(center, half[k])
            gt_classes[t, k] = cls_ids[k]
            # Detection (possibly dropped).
            if rng.uniform() < drop_prob or slot >= I:
                continue
            jitter = rng.normal(scale=noise, size=3)
            det_valid[t, slot] = True
            translations[t, slot] = center + jitter
            rotations[t, slot] = obj_rot[k] + rng.normal(scale=noise, size=3)
            scales[t, slot] = obj_scale[k] * (1 + rng.normal(scale=noise))
            pred_boxes[t, slot] = _corners(center + jitter, half[k] * (1 + rng.normal(scale=noise)))
            voxels[t, slot] = blobs[k]
            classes[t, slot] = cls_ids[k]
            slot += 1
        # Spurious false-positive detection far from everything.
        if rng.uniform() < fp_prob and slot < I:
            center = rng.uniform(5, 8, size=3)
            det_valid[t, slot] = True
            translations[t, slot] = center
            rotations[t, slot] = rng.uniform(-1, 1, size=3)
            scales[t, slot] = 1.0
            pred_boxes[t, slot] = _corners(center, np.array([0.3, 0.3, 0.3]))
            voxels[t, slot] = rng.uniform(size=(32, 32, 32)) < 0.1
            classes[t, slot] = rng.integers(0, 7)

    return SyntheticSequence(
        det_valid, translations, rotations, scales, pred_boxes, voxels,
        classes, gt_valid, gt_ids, gt_locations, gt_rotations, gt_scales,
        gt_boxes, gt_classes)
