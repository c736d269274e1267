"""Trajectory assembly + MOTA evaluation (host side); the port's own copy
of `mot3d_tpu/tracking/tracker.py`.

Mirrors the reference `Tracker` (`Tracking/tracker/tracking_front.py:9-383`)
protocol on top of our padded graphs:

  - edge probabilities are binarised at 0.5; only *consecutive* (dt == 1)
    forward edges participate (`tracking_front.py:267-283`);
  - detections in a frame whose successor frame is empty are kept as
    "unique detections" so they are not dropped (`graph_dataset.py:102-113`);
  - predicted trajectories are keyed on each detection's GT-matched identity
    (obj_idx from 3D-IoU matching) and assembled greedily from the first
    frame (`tracking_front.py:319-383`);
  - ground-truth trajectories come straight from per-frame GT annotations;
  - MOTA/precision/recall via the gated-Hungarian accumulator
    (tracking/mot_metrics.py), overall and per class.

This is evaluation-time bookkeeping over a handful of objects, in host
numpy as in the JAX package.  It takes numpy arrays: move one sequence's
`SequenceOutputs` to the host in a single transfer
(`parallel/infer_step.py:outputs_to_host`) rather than field by field.
pandas is needed only by `traj_table` and is imported there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mot3d_tpu_torch.config import MOTFRONT_CLASSES, TrackingConfig
from mot3d_tpu_torch.tracking.graph_builder import GraphTemplate
from mot3d_tpu_torch.tracking.mot_metrics import (TrajArrays,
                                                  mot_summary_arrays)


class Tracker:
    def __init__(self, cfg: TrackingConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------
    def assemble(self, template: GraphTemplate,
                 edge_probs: np.ndarray,       # (E,) forward-half sigmoids
                 obj_ids: np.ndarray,          # (T, I) GT identity, -1 = FP
                 det_valid: np.ndarray,        # (T, I)
                 translations: np.ndarray,     # (T, I, 3)
                 classes: np.ndarray,          # (T, I)
                 ) -> List[List[dict]]:
        """Predicted trajectories: list of [{scan_idx, obj_idx, loc, cls}]."""
        T, I = det_valid.shape
        t_tmpl = int(template.dst_frame.max()) + 1
        if t_tmpl > T:
            raise ValueError(
                f"graph template spans {t_tmpl} frames but detections have "
                f"{T}; build the template with seq_len={T} or frame-pad the "
                f"sequence (data.h5_io.pad_sequence(..., seq_len=...))")
        thresh = self.cfg.edge_threshold

        # Detections entering the track graph per frame, via positive
        # consecutive edges.  Vectorised: the edge filter and the
        # endpoint-expansion run as numpy array ops, and each (frame, slot)
        # pair is materialised as a dict once (first edge-order occurrence)
        # instead of once per incident edge — the greedy assembly below
        # dedups by obj_idx anyway, so dropping later duplicates of the
        # same slot is behaviour-preserving while cutting the Python-loop
        # work from O(edges) to O(unique detections).
        per_frame: List[List[dict]] = [[] for _ in range(T)]

        consec = template.dt == 1
        pos = edge_probs >= thresh
        ts, si = template.src_frame, template.src_slot
        td, sj = template.dst_frame, template.dst_slot
        keep = (consec & pos
                & det_valid[ts, si] & det_valid[td, sj]
                & (obj_ids[ts, si] >= 0) & (obj_ids[td, sj] >= 0))
        # (src, dst) interleaved in edge order == the original append order.
        et = np.stack([ts[keep], td[keep]], axis=1).ravel()
        es = np.stack([si[keep], sj[keep]], axis=1).ravel()
        flat = et * det_valid.shape[1] + es
        _, first = np.unique(flat, return_index=True)
        for idx in np.sort(first):
            t, i = int(et[idx]), int(es[idx])
            per_frame[t].append(self._det(t, i, obj_ids, translations, classes))

        # Unique detections: frame t matched detections whose successor frame
        # has no detections at all (they have no consecutive edges).
        for t in range(T - 1):
            if det_valid[t + 1].any():
                continue
            for i in np.nonzero(det_valid[t])[0]:
                if obj_ids[t, int(i)] >= 0:
                    per_frame[t].append(
                        self._det(t, int(i), obj_ids, translations, classes))

        # Greedy identity-keyed assembly (tracking_front.py:319-383).  At
        # most one trajectory exists per obj_idx (a second det with a seen
        # id is always appended to the existing track), so the linear
        # trajectory scan is an exact dict lookup.
        trajectories: List[List[dict]] = []
        by_id: dict = {}
        for t in range(T):
            used_ids: set = set()
            for det in per_frame[t]:
                oid = det["obj_idx"]
                if oid in used_ids:
                    continue
                traj = by_id.get(oid)
                if traj is not None:
                    if traj[-1]["scan_idx"] != t:
                        traj.append(det)
                else:
                    traj = [det]
                    trajectories.append(traj)
                    by_id[oid] = traj
                used_ids.add(oid)
        return trajectories

    @staticmethod
    def _det(t, i, obj_ids, translations, classes) -> dict:
        return {
            "scan_idx": t,
            "obj_idx": int(obj_ids[t, i]),
            "loc": np.asarray(translations[t, i], dtype=np.float64),
            "cls": int(classes[t, i]),
        }

    # ------------------------------------------------------------------
    def gt_trajectories(self, gt_ids: np.ndarray, gt_valid: np.ndarray,
                        gt_locations: np.ndarray,
                        gt_classes: np.ndarray) -> List[List[dict]]:
        """GT trajectories from per-frame annotations (T, G)."""
        T = gt_valid.shape[0]
        trajs: Dict[int, List[dict]] = {}
        for t in range(T):
            for g in np.nonzero(gt_valid[t])[0]:
                oid = int(gt_ids[t, g])
                det = {"scan_idx": t, "obj_idx": oid,
                       "loc": np.asarray(gt_locations[t, g], np.float64),
                       "cls": int(gt_classes[t, g])}
                trajs.setdefault(oid, []).append(det)
        return list(trajs.values())

    # ------------------------------------------------------------------
    @staticmethod
    def traj_table(trajectories: List[List[dict]]):
        """Trajectories -> flat pandas table, schema of `get_traj_tables`
        (`tracking_front.py:873-878`)."""
        import pandas as pd

        rows = []
        for traj in trajectories:
            for det in traj:
                rows.append({
                    "scan_idx": det["scan_idx"],
                    "world_x": det["loc"][0],
                    "world_y": det["loc"][1],
                    "world_z": det["loc"][2],
                    "obj_idx": det["obj_idx"],
                    "obj_cls": det["cls"],
                })
        if not rows:
            return pd.DataFrame(columns=["scan_idx", "world_x", "world_y",
                                         "world_z", "obj_idx", "obj_cls"])
        return pd.DataFrame(rows)

    # ------------------------------------------------------------------
    def evaluate(self, pred_trajectories, gt_trajectories,
                 classwise: bool = False):
        """MOTA summary (+ per-class summaries when classwise=True).

        Runs on flat numpy arrays (`TrajArrays`) rather than the pandas
        tables of `traj_table` — identical results, ~20x less host time at
        dataset-scale validation (pandas row filtering dominated)."""
        pred_a = TrajArrays.from_trajectories(pred_trajectories)
        gt_a = TrajArrays.from_trajectories(gt_trajectories)
        overall = mot_summary_arrays(pred_a, gt_a, self.cfg.seq_len,
                                     self.cfg.mota_l2_gate)
        if not classwise:
            return overall
        per_class = {}
        for ci, cname in enumerate(MOTFRONT_CLASSES):
            gt_c = gt_a.of_class(ci)
            if len(gt_c.scan) == 0:
                continue
            per_class[cname] = mot_summary_arrays(
                pred_a.of_class(ci), gt_c, self.cfg.seq_len,
                self.cfg.mota_l2_gate)
        return overall, per_class
