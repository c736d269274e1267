"""The training sample type (counterpart of
`mot3d_tpu/data/detection_loader.py:DetectionSample`); the MOTFront reader
that fills it is not ported yet (ROADMAP.md Queue 1)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class DetectionSample(NamedTuple):
    """One padded frame (numpy, host)."""

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
