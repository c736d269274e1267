"""Edge-classification metrics (precision / recall / F1 on binarised edges);
the port's own copy of `mot3d_tpu/evaluator/edge_metrics.py`.

Mirrors `Tracking/utils/eval_utils.py:14-42` (sklearn-based in the
reference); plain NumPy here.
"""

from __future__ import annotations

import numpy as np


def edge_precision_recall_f1(probs, targets, mask=None, threshold=0.5):
    probs = np.asarray(probs)
    targets = np.asarray(targets) >= 0.5
    pred = probs >= threshold
    if mask is not None:
        m = np.asarray(mask, bool)
        pred, targets = pred[m], targets[m]
    tp = np.logical_and(pred, targets).sum()
    fp = np.logical_and(pred, ~targets).sum()
    fn = np.logical_and(~pred, targets).sum()
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"precision": float(precision), "recall": float(recall),
            "f1": float(f1)}
