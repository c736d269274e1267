"""Heuristic L2 tracker, the non-graph baseline (counterpart of
`mot3d_tpu/tracking/heuristic.py`; host numpy).

Mirrors `Tracking/tracker/tracking_front.py:24-255` (pred_trajectory +
analyse_trajectories_nograph): greedy nearest-last-position matching with a
distance threshold and a per-frame duplicate guard.  Used for the office
(no-GT) pipeline and as the graph-free ablation.
"""

from __future__ import annotations

from typing import List

import numpy as np


class HeuristicTracker:
    def __init__(self, dist_thres: float = 0.25, similar_thres: float = 0.2,
                 seq_len: int = 25):
        self.dist_thres = dist_thres
        self.similar_thres = similar_thres
        self.seq_len = seq_len

    def _has_similar(self, trajectories, loc, scan_idx) -> bool:
        for traj in trajectories:
            last = traj[-1]
            if last["scan_idx"] == scan_idx and np.linalg.norm(
                    np.asarray(last["loc"]) - loc) < self.similar_thres:
                return True
        return False

    def step(self, trajectories: List[List[dict]], det: dict,
             scan_idx: int) -> List[List[dict]]:
        """Assign one detection dict {loc, ...} at frame scan_idx."""
        loc = np.asarray(det["loc"], np.float64)
        rec = dict(det)
        rec["scan_idx"] = scan_idx
        if not trajectories:
            return [[rec]]
        dists = [np.linalg.norm(np.asarray(t[-1]["loc"]) - loc)
                 for t in trajectories]
        i = int(np.argmin(dists))
        if self._has_similar(trajectories, loc, scan_idx):
            return trajectories
        if dists[i] < self.dist_thres:
            trajectories[i].append(rec)
        else:
            trajectories.append([rec])
        return trajectories

    def track(self, per_frame_dets: List[List[dict]]) -> List[List[dict]]:
        """per_frame_dets[t] = list of {loc, ...} detection dicts; each
        trajectory's records get `obj_idx` = its first-frame order."""
        trajectories: List[List[dict]] = []
        for t, dets in enumerate(per_frame_dets):
            for det in dets:
                trajectories = self.step(trajectories, det, t)
        for i, traj in enumerate(trajectories):
            for d in traj:
                d.setdefault("obj_idx", i)
        return trajectories
