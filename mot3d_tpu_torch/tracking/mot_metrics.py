"""MOT metric accumulation (MOTA / precision / recall / switches); the
port's own copy of `mot3d_tpu/tracking/mot_metrics.py` (host numpy + scipy).

Self-contained, motmetrics-compatible replacement for the reference's
`motmetrics.MOTAccumulator` + `mm.metrics.compute` usage
(`Tracking/tracker/tracking_front.py:946-1014`); motmetrics is not available
in this environment.  Semantics follow motmetrics:

  - per frame, previously established GT->hyp correspondences are re-applied
    first when both sides are present and the gated distance is finite;
  - the remainder is matched with the Hungarian algorithm on the distance
    matrix (NaN = impossible pair);
  - events: MATCH, SWITCH (a GT object matched to a different hypothesis than
    its last known match), MISS (unmatched GT), FP (unmatched hypothesis);
  - MOTA = 1 - (misses + fps + switches) / num_objects;
    precision = detections / (detections + fps);
    recall = detections / num_objects, detections = matches + switches.

This is host-side evaluation code (as in the reference) — the association
per frame is a tiny Hungarian problem, not a device workload.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment


def norm2squared_matrix(objs: np.ndarray, hyps: np.ndarray,
                        max_d2: float) -> np.ndarray:
    """Pairwise squared L2, gated: entries > max_d2 become NaN
    (motmetrics.distances.norm2squared_matrix)."""
    objs = np.atleast_2d(np.asarray(objs, dtype=np.float64))
    hyps = np.atleast_2d(np.asarray(hyps, dtype=np.float64))
    if objs.size == 0 or hyps.size == 0:
        return np.empty((len(objs), len(hyps)))
    d2 = ((objs[:, None, :] - hyps[None, :, :]) ** 2).sum(-1)
    return np.where(d2 > max_d2, np.nan, d2)


class MOTAccumulator:
    """Frame-by-frame event accumulator."""

    def __init__(self) -> None:
        self.last_match: Dict[Hashable, Hashable] = {}
        self.num_objects = 0
        self.num_hypotheses = 0
        self.num_matches = 0
        self.num_switches = 0
        self.num_misses = 0
        self.num_false_positives = 0
        self.num_frames = 0
        self.events: List[tuple] = []
        # (gt id, hyp id) -> frames where the pair is within the gate;
        # feeds the global ID assignment behind IDF1 (Ristani et al., as
        # in motmetrics' id_global_assignment).
        self.pair_frames: Dict[tuple, int] = {}

    def update(self, gt_ids: Sequence[Hashable], hyp_ids: Sequence[Hashable],
               dists: np.ndarray) -> None:
        """dists: (len(gt_ids), len(hyp_ids)), NaN = pair not allowed."""
        self.num_frames += 1
        self.num_objects += len(gt_ids)
        self.num_hypotheses += len(hyp_ids)
        dists = np.asarray(dists, dtype=np.float64).reshape(
            len(gt_ids), len(hyp_ids))

        # IDF1 bookkeeping: every within-gate (gt, hyp) co-occurrence counts
        # as a candidate identity match, independent of the per-frame
        # event assignment below.
        for gi_, hi_ in zip(*np.nonzero(~np.isnan(dists))):
            key = (gt_ids[gi_], hyp_ids[hi_])
            self.pair_frames[key] = self.pair_frames.get(key, 0) + 1

        matched_g: Dict[int, int] = {}
        used_h: set = set()

        # 1) continuity: re-apply previous correspondences when still valid.
        for gi, g in enumerate(gt_ids):
            h_prev = self.last_match.get(g)
            if h_prev is None or h_prev not in hyp_ids:
                continue
            hi = list(hyp_ids).index(h_prev)
            if hi in used_h or np.isnan(dists[gi, hi]):
                continue
            matched_g[gi] = hi
            used_h.add(hi)

        # 2) Hungarian on the remainder.
        rem_g = [i for i in range(len(gt_ids)) if i not in matched_g]
        rem_h = [j for j in range(len(hyp_ids)) if j not in used_h]
        if rem_g and rem_h:
            sub = dists[np.ix_(rem_g, rem_h)]
            cost = np.where(np.isnan(sub), 1e18, sub)
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if np.isnan(sub[r, c]):
                    continue
                matched_g[rem_g[r]] = rem_h[c]
                used_h.add(rem_h[c])

        # 3) events.
        for gi, hi in matched_g.items():
            g, h = gt_ids[gi], hyp_ids[hi]
            prev = self.last_match.get(g)
            if prev is not None and prev != h:
                self.num_switches += 1
                self.events.append(("SWITCH", self.num_frames - 1, g, h))
            else:
                self.num_matches += 1
                self.events.append(("MATCH", self.num_frames - 1, g, h))
            self.last_match[g] = h
        for gi in range(len(gt_ids)):
            if gi not in matched_g:
                self.num_misses += 1
                self.events.append(("MISS", self.num_frames - 1, gt_ids[gi], None))
        for hi in range(len(hyp_ids)):
            if hi not in used_h:
                self.num_false_positives += 1
                self.events.append(("FP", self.num_frames - 1, None, hyp_ids[hi]))

    def idtp(self) -> int:
        """ID true positives: one global bipartite assignment GT id <-> hyp
        id maximising the number of within-gate co-occurring frames
        (Ristani et al.; motmetrics' id_global_assignment)."""
        if not self.pair_frames:
            return 0
        g_ids = sorted({g for g, _ in self.pair_frames})
        h_ids = sorted({h for _, h in self.pair_frames})
        gi = {g: i for i, g in enumerate(g_ids)}
        hi = {h: i for i, h in enumerate(h_ids)}
        overlap = np.zeros((len(g_ids), len(h_ids)))
        for (g, h), n in self.pair_frames.items():
            overlap[gi[g], hi[h]] = n
        rows, cols = linear_sum_assignment(-overlap)
        return int(overlap[rows, cols].sum())

    def idf1(self) -> float:
        """ID-F1 = 2*IDTP / (gt dets + hyp dets)."""
        total = self.num_objects + self.num_hypotheses
        if total == 0:
            return 1.0
        return 2.0 * self.idtp() / total

    def summary(self) -> Dict[str, float]:
        detections = self.num_matches + self.num_switches
        n_obj = max(self.num_objects, 1)
        idtp = self.idtp()
        total_dets = self.num_objects + self.num_hypotheses
        return {
            "num_frames": self.num_frames,
            "mota": 1.0 - (self.num_misses + self.num_false_positives
                           + self.num_switches) / n_obj,
            "idf1": 1.0 if total_dets == 0 else 2.0 * idtp / total_dets,
            "idtp": idtp,
            "num_hypotheses": self.num_hypotheses,
            "precision": detections / max(detections + self.num_false_positives, 1),
            "recall": detections / n_obj,
            "num_objects": self.num_objects,
            "num_matches": self.num_matches,
            "num_misses": self.num_misses,
            "num_false_positives": self.num_false_positives,
            "num_switches": self.num_switches,
        }


class TrajArrays:
    """Flat per-detection arrays of a trajectory table, sorted by frame.

    The numpy-native form of the reference's `get_traj_table` schema
    (`tracking_front.py:845-878`): per-frame slicing becomes two
    searchsorted calls instead of a pandas boolean filter (which measured
    ~85% of the whole MOTA evaluation at dataset scale)."""

    __slots__ = ("scan", "loc", "ids", "cls")

    def __init__(self, scan, loc, ids, cls):
        order = np.argsort(scan, kind="stable")  # keep within-frame order
        self.scan = scan[order]
        self.loc = loc[order]
        self.ids = ids[order]
        self.cls = cls[order]

    @classmethod
    def from_table(cls, table) -> "TrajArrays":
        if len(table) == 0:
            return cls(np.zeros(0, np.int64), np.zeros((0, 3)),
                       np.zeros(0, np.int64), np.zeros(0, np.int64))
        return cls(table["scan_idx"].to_numpy(np.int64),
                   table[["world_x", "world_y", "world_z"]]
                   .to_numpy(np.float64),
                   table["obj_idx"].to_numpy(np.int64),
                   table["obj_cls"].to_numpy(np.int64))

    @classmethod
    def from_trajectories(cls, trajectories) -> "TrajArrays":
        dets = [d for traj in trajectories for d in traj]
        if not dets:
            return cls(np.zeros(0, np.int64), np.zeros((0, 3)),
                       np.zeros(0, np.int64), np.zeros(0, np.int64))
        return cls(np.array([d["scan_idx"] for d in dets], np.int64),
                   np.array([d["loc"] for d in dets], np.float64),
                   np.array([d["obj_idx"] for d in dets], np.int64),
                   np.array([d["cls"] for d in dets], np.int64))

    def of_class(self, ci: int) -> "TrajArrays":
        m = self.cls == ci
        out = object.__new__(TrajArrays)  # rows already frame-sorted
        out.scan, out.loc = self.scan[m], self.loc[m]
        out.ids, out.cls = self.ids[m], self.cls[m]
        return out


def mot_summary_arrays(pred: TrajArrays, gt: TrajArrays, seq_len: int,
                       l2_gate: float = 0.4) -> Dict[str, float]:
    """MOTA summary from TrajArrays.  Mirrors `eval_mota`
    (`tracking_front.py:946-979`): per frame, the distance matrix is the
    squared-L2 gated at l2_gate."""
    acc = MOTAccumulator()
    frames = np.arange(seq_len + 1)
    g_ofs = np.searchsorted(gt.scan, frames)
    p_ofs = np.searchsorted(pred.scan, frames)
    for scan_idx in range(seq_len):
        g0, g1 = g_ofs[scan_idx], g_ofs[scan_idx + 1]
        p0, p1 = p_ofs[scan_idx], p_ofs[scan_idx + 1]
        gt_ids = gt.ids[g0:g1].tolist()
        hyp_ids = pred.ids[p0:p1].tolist()
        dists = norm2squared_matrix(gt.loc[g0:g1], pred.loc[p0:p1],
                                    max_d2=l2_gate)
        acc.update(gt_ids, hyp_ids, dists)
    return acc.summary()


def mot_summary(pred_table, gt_table, seq_len: int,
                l2_gate: float = 0.4) -> Dict[str, float]:
    """MOTA summary from trajectory tables.

    Tables are pandas DataFrames with columns
    [scan_idx, world_x, world_y, world_z, obj_idx, obj_cls] — the schema of
    the reference's `get_traj_table` (`tracking_front.py:845-878`).
    """
    return mot_summary_arrays(TrajArrays.from_table(pred_table),
                              TrajArrays.from_table(gt_table),
                              seq_len, l2_gate)


def accumulated_idf1(summaries: Sequence[Dict[str, float]]) -> float:
    """Dataset-level IDF1 from per-sequence summaries.  Sequences have
    disjoint identity spaces, so the global ID assignment decomposes per
    sequence: IDF1 = 2 * sum(IDTP_i) / sum(gt dets_i + hyp dets_i)."""
    idtp = sum(s["idtp"] for s in summaries)
    total = sum(s["num_objects"] + s["num_hypotheses"] for s in summaries)
    return 1.0 if total == 0 else 2.0 * idtp / total


def accumulated_mota(summaries: Sequence[Dict[str, float]]) -> float:
    """Dataset-level MOTA from per-sequence summaries:
    1 - (sum misses + FPs + switches) / (sum objects)
    (`Tracking/utils/eval_utils.py:43-64`, get_mota_df)."""
    miss = sum(s["num_misses"] for s in summaries)
    fp = sum(s["num_false_positives"] for s in summaries)
    sw = sum(s["num_switches"] for s in summaries)
    obj = max(sum(s["num_objects"] for s in summaries), 1)
    return 1.0 - (miss + fp + sw) / obj
