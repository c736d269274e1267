"""Per-frame detection .h5 interchange files (counterpart of
`mot3d_tpu/data/h5_io.py`).

Bit-compatible with the schema written by the reference's
`inference_detector.py:352-391` and read by
`Tracking/datasets/front_dataset.py:58-77`, so either half of either
pipeline can interoperate:

  pred keys: classes, objectness_scores, voxels, rotations, translations,
             scales, pred_3Dbbox
  gt keys:   gt_3Dbbox, gt_objid, gt_voxels, gt_rotations, gt_locations,
             gt_scales, gt_compl_box, gt_cls

Ragged per-frame arrays on disk <-> fixed-size padded tensors in memory
(static shapes).  `gt_cls` on disk is 1-based (the reference subtracts 1
on read, `front_dataset.py:68`); in-memory classes are 0-based
everywhere.  `h5py` is imported when a file is read or written.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class FrameDetections(NamedTuple):
    """Ragged (unpadded) per-frame record — the on-disk truth."""

    classes: np.ndarray             # (N,) int, 0-based
    objectness_scores: np.ndarray   # (N,)
    voxels: np.ndarray              # (N, 32, 32, 32)
    rotations: np.ndarray           # (N, 3) euler
    translations: np.ndarray        # (N, 3)
    scales: np.ndarray              # (N,)
    pred_boxes: np.ndarray          # (N, 8, 3)
    gt_ids: np.ndarray              # (G,)
    gt_boxes: np.ndarray            # (G, 8, 3)
    gt_voxels: np.ndarray           # (G, 32, 32, 32)
    gt_rotations: np.ndarray        # (G, 3)
    gt_locations: np.ndarray        # (G, 3)
    gt_scales: np.ndarray           # (G,) or (G, 3)
    gt_compl_boxes: np.ndarray      # (G, 8, 3)
    gt_classes: np.ndarray          # (G,) int, 0-based


def write_frame_h5(path: str, frame: FrameDetections) -> None:
    """Write one frame in the reference's layout (gt_cls stored 1-based)."""
    import h5py
    os.makedirs(os.path.dirname(path), exist_ok=True)
    empty = np.array([])
    has_pred = len(frame.classes) > 0
    with h5py.File(path, "w") as hf:
        hf.create_dataset("classes", data=frame.classes if has_pred else empty)
        hf.create_dataset("objectness_scores",
                          data=frame.objectness_scores if has_pred else empty)
        hf.create_dataset("voxels", data=frame.voxels if has_pred else empty)
        hf.create_dataset("rotations", data=frame.rotations if has_pred else empty)
        hf.create_dataset("translations",
                          data=frame.translations if has_pred else empty)
        hf.create_dataset("scales", data=frame.scales if has_pred else empty)
        hf.create_dataset("pred_3Dbbox",
                          data=frame.pred_boxes if has_pred else empty)
        hf.create_dataset("gt_3Dbbox", data=frame.gt_boxes)
        hf.create_dataset("gt_objid", data=frame.gt_ids)
        hf.create_dataset("gt_voxels", data=frame.gt_voxels)
        hf.create_dataset("gt_rotations", data=frame.gt_rotations)
        hf.create_dataset("gt_locations", data=frame.gt_locations)
        hf.create_dataset("gt_scales", data=frame.gt_scales)
        hf.create_dataset("gt_compl_box", data=frame.gt_compl_boxes)
        hf.create_dataset("gt_cls", data=np.asarray(frame.gt_classes) + 1)


def read_frame_h5(path: str) -> FrameDetections:
    import h5py
    with h5py.File(path, "r") as hf:
        def get(key):
            v = hf.get(key)
            return np.array(v) if v is not None else np.array([])

        classes = get("classes")
        return FrameDetections(
            classes=classes.astype(np.int32) if classes.size else classes,
            objectness_scores=get("objectness_scores"),
            voxels=get("voxels"),
            rotations=get("rotations"),
            translations=get("translations"),
            scales=get("scales"),
            pred_boxes=get("pred_3Dbbox"),
            gt_ids=get("gt_objid"),
            gt_boxes=get("gt_3Dbbox"),
            gt_voxels=get("gt_voxels"),
            gt_rotations=get("gt_rotations"),
            gt_locations=get("gt_locations"),
            gt_scales=get("gt_scales"),
            gt_compl_boxes=get("gt_compl_box"),
            gt_classes=(get("gt_cls") - 1).astype(np.int32)
            if get("gt_cls").size else np.array([], np.int32),
        )


def pad_sequence(frames, max_instances: int, max_gt: int,
                 seq_len: int | None = None):
    """Ragged frame records -> the padded tensor dict the graph builder eats.

    Returns a dict of (T, ...) numpy arrays matching
    the JAX package's `SyntheticSequence` field names.

    seq_len: when given, pad the frame axis up to it (padded frames carry
    det_valid/gt_valid False, so graph edges touching them are masked) —
    every sequence fed to one graph template must share its T.
    """
    T = max(len(frames), seq_len or 0)
    I, G = max_instances, max_gt
    out = {
        "det_valid": np.zeros((T, I), bool),
        "translations": np.zeros((T, I, 3), np.float32),
        "rotations": np.zeros((T, I, 3), np.float32),
        "scales": np.ones((T, I), np.float32),
        "pred_boxes": np.zeros((T, I, 8, 3), np.float32),
        "voxels": np.zeros((T, I, 32, 32, 32), np.float32),
        "classes": np.zeros((T, I), np.int32),
        "objectness": np.zeros((T, I), np.float32),
        "gt_valid": np.zeros((T, G), bool),
        "gt_ids": np.full((T, G), -1, np.int32),
        "gt_locations": np.zeros((T, G, 3), np.float32),
        "gt_rotations": np.zeros((T, G, 3), np.float32),
        "gt_scales": np.ones((T, G), np.float32),
        "gt_boxes": np.zeros((T, G, 8, 3), np.float32),
        "gt_classes": np.zeros((T, G), np.int32),
    }
    for t, f in enumerate(frames):
        n = min(len(f.classes), I)
        if n:
            out["det_valid"][t, :n] = True
            out["translations"][t, :n] = f.translations[:n]
            out["rotations"][t, :n] = f.rotations[:n]
            out["scales"][t, :n] = f.scales[:n]
            out["pred_boxes"][t, :n] = f.pred_boxes[:n]
            out["voxels"][t, :n] = f.voxels[:n]
            out["classes"][t, :n] = f.classes[:n]
            out["objectness"][t, :n] = f.objectness_scores[:n]
        g = min(len(f.gt_ids), G)
        if g:
            out["gt_valid"][t, :g] = True
            out["gt_ids"][t, :g] = f.gt_ids[:g]
            out["gt_locations"][t, :g] = f.gt_locations[:g]
            out["gt_rotations"][t, :g] = f.gt_rotations[:g]
            gs = np.asarray(f.gt_scales[:g])
            out["gt_scales"][t, :g] = gs if gs.ndim == 1 else gs[:, 0]
            out["gt_boxes"][t, :g] = f.gt_boxes[:g]
            out["gt_classes"][t, :g] = f.gt_classes[:g]
    return out
