"""COCO-protocol detection AP (bbox + segm), host-side NumPy (a copy of
`mot3d_tpu/evaluator/coco_eval.py`).

From-scratch implementation of the evaluation protocol used by the
reference's vendored `Detection/evaluator/CocoEvaluator.py` /
`FrontCocoEval.py` (pycocotools COCOeval): greedy per-image matching at IoU
thresholds 0.5:0.05:0.95, score-sorted, 101-point interpolated
precision-recall, AP / AP50 / AP75 / APs / APm / APl / per-class AP,
maxDets=100.  Area ranges use the protocol's ignore semantics
(`FrontCocoEval.py` Params.areaRng + evaluateImg): out-of-range GTs are
*ignored* (sorted last, matchable but not counted), and unmatched
detections outside the range are excluded from the FP count rather than
filtered up front.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from mot3d_tpu_torch.evaluator import rle as rle_mod

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
# pycocotools Params.areaRng (FrontCocoEval.py): all/small/medium/large.
AREA_RANGES: Dict[str, Tuple[float, float]] = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _bbox_iou_matrix(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """XYWH boxes -> IoU matrix (nd, ng)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx0, dy0 = dt[:, 0:1], dt[:, 1:2]
    dx1, dy1 = dx0 + dt[:, 2:3], dy0 + dt[:, 3:4]
    gx0, gy0 = gt[None, :, 0], gt[None, :, 1]
    gx1, gy1 = gx0 + gt[None, :, 2], gy0 + gt[None, :, 3]
    iw = np.clip(np.minimum(dx1, gx1) - np.maximum(dx0, gx0), 0, None)
    ih = np.clip(np.minimum(dy1, gy1) - np.maximum(dy0, gy0), 0, None)
    inter = iw * ih
    union = (dt[:, 2:3] * dt[:, 3:4]) + gt[None, :, 2] * gt[None, :, 3] - inter
    return np.where(union > 0, inter / union, 0.0)


def _match_image(dt_scores, ious, gt_ignore, dt_out_of_range, thresholds):
    """Greedy COCO matching for one image+class+area-range
    (pycocotools COCOeval.evaluateImg).

    gt_ignore: (ng,) bool — out-of-range GTs; matchable but not counted.
    dt_out_of_range: (nd,) bool — DT area outside the range; an unmatched
    out-of-range DT is ignored (not an FP).
    Returns (tp, dt_ig, sorted_scores), each (T, nd) / (nd,) in score-sorted
    order."""
    nd = len(dt_scores)
    ng = len(gt_ignore)
    order = np.argsort(-dt_scores, kind="mergesort")
    # GTs sorted ignored-last, as the protocol requires for match priority.
    gt_order = np.argsort(gt_ignore, kind="mergesort")
    tp = np.zeros((len(thresholds), nd), bool)
    dt_ig = np.zeros((len(thresholds), nd), bool)
    for ti, thr in enumerate(thresholds):
        gt_used = np.zeros(ng, bool)
        for rank, di in enumerate(order):
            best, best_iou = -1, min(thr, 1 - 1e-10)
            for gi in gt_order:
                if gt_used[gi]:
                    continue
                # Once matched to a non-ignored GT, never trade it for an
                # ignored one (ignored GTs are sorted last).
                if best >= 0 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if ious[di, gi] >= best_iou:
                    best, best_iou = gi, ious[di, gi]
            if best >= 0:
                gt_used[best] = True
                if gt_ignore[best]:
                    dt_ig[ti, rank] = True
                else:
                    tp[ti, rank] = True
            elif dt_out_of_range[di]:
                dt_ig[ti, rank] = True
    return tp, dt_ig, dt_scores[order]


def compute_ap(per_image: List[dict], num_classes: int,
               iou_type: str = "bbox", max_dets: int = 100
               ) -> Dict[str, float]:
    """per_image: list of dicts with keys
         dt_boxes (N, 4) XYWH, dt_scores (N,), dt_classes (N,),
         gt_boxes (M, 4) XYWH, gt_classes (M,)
       and for iou_type == "segm" additionally dt_rles / gt_rles
       (lists of RLE dicts aligned with the boxes) and optionally
       dt_areas / gt_areas (mask areas; default = box areas).
    Returns {"AP", "AP50", "AP75", "APs", "APm", "APl", "AP/class_<i>"...}.
    """
    results: Dict[str, float] = {}
    for rng_name, (amin, amax) in AREA_RANGES.items():
        ap_all = []
        per_class_ap: Dict[int, float] = {}
        for cls in range(num_classes):
            tps, igs, scores_all, n_gt_total = [], [], [], 0
            for img in per_image:
                dt_sel = np.asarray(img["dt_classes"]) == cls
                gt_sel = np.asarray(img["gt_classes"]) == cls
                gt_areas = np.asarray(img.get(
                    "gt_areas",
                    np.asarray(img["gt_boxes"])[:, 2]
                    * np.asarray(img["gt_boxes"])[:, 3]))[gt_sel]
                dt_areas = np.asarray(img.get(
                    "dt_areas",
                    np.asarray(img["dt_boxes"])[:, 2]
                    * np.asarray(img["dt_boxes"])[:, 3]))[dt_sel][:max_dets]
                gt_ignore = (gt_areas < amin) | (gt_areas > amax)
                n_gt = int((~gt_ignore).sum())
                n_gt_total += n_gt
                if dt_sel.sum() == 0:
                    continue
                dt_scores = np.asarray(img["dt_scores"])[dt_sel][:max_dets]
                if iou_type == "segm":
                    dts = [r for r, s in zip(img["dt_rles"], dt_sel) if s]
                    gts = [r for r, s in zip(img["gt_rles"], gt_sel) if s]
                    ious = rle_mod.iou(dts[:max_dets], gts)
                else:
                    ious = _bbox_iou_matrix(
                        np.asarray(img["dt_boxes"])[dt_sel][:max_dets],
                        np.asarray(img["gt_boxes"])[gt_sel])
                dt_oor = (dt_areas < amin) | (dt_areas > amax)
                tp, dt_ig, sorted_scores = _match_image(
                    dt_scores, ious, gt_ignore, dt_oor, IOU_THRESHOLDS)
                tps.append(tp)
                igs.append(dt_ig)
                scores_all.append(sorted_scores)
            if n_gt_total == 0:
                continue
            if not tps:
                per_class_ap[cls] = 0.0
                ap_all.append(np.zeros(len(IOU_THRESHOLDS)))
                continue
            tp = np.concatenate(tps, axis=1)
            ig = np.concatenate(igs, axis=1)
            scores = np.concatenate(scores_all)
            order = np.argsort(-scores, kind="mergesort")
            tp, ig = tp[:, order], ig[:, order]
            aps = np.zeros(len(IOU_THRESHOLDS))
            for ti in range(len(IOU_THRESHOLDS)):
                keep = ~ig[ti]
                t = tp[ti][keep]
                cum_tp = np.cumsum(t)
                cum_fp = np.cumsum(~t)
                recall = cum_tp / n_gt_total
                precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
                # monotone non-increasing envelope
                p = np.maximum.accumulate(precision[::-1])[::-1]
                # 101-point interpolation
                idx = np.searchsorted(recall, RECALL_POINTS, side="left")
                q = np.where(idx < len(p),
                             p[np.minimum(idx, max(len(p) - 1, 0))]
                             if len(p) else 0.0, 0.0)
                aps[ti] = q.mean()
            ap_all.append(aps)
            per_class_ap[cls] = float(aps.mean())

        if not ap_all:
            continue
        stack = np.stack(ap_all)
        if rng_name == "all":
            results["AP"] = float(stack.mean())
            results["AP50"] = float(stack[:, 0].mean())
            results["AP75"] = float(stack[:, 5].mean())
            for cls, v in per_class_ap.items():
                results[f"AP/class_{cls}"] = v
        else:
            results[f"AP{rng_name[0]}"] = float(stack.mean())
    return results


class COCOEvaluator:
    """Accumulating evaluator over padded detections.

    Mirrors the reference's COCOEvaluator usage
    (`Detection/evaluator/CocoEvaluator.py:32`, save_ap
    `EvaluatorUtils.py:358-415`): feed per-image padded detector outputs +
    ground truth, then `summarize()` for bbox (and segm when masks given) AP.
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.per_image_bbox: List[dict] = []
        self.per_image_segm: List[dict] = []

    @staticmethod
    def _xyxy_to_xywh(b):
        b = np.asarray(b, np.float64)
        out = b.copy()
        out[:, 2] = b[:, 2] - b[:, 0]
        out[:, 3] = b[:, 3] - b[:, 1]
        return out

    def add_image(self, dt_boxes_xyxy, dt_scores, dt_classes, dt_valid,
                  gt_boxes_xyxy, gt_classes, gt_valid,
                  dt_masks=None, gt_masks=None):
        dv = np.asarray(dt_valid, bool)
        gv = np.asarray(gt_valid, bool)
        rec = {
            "dt_boxes": self._xyxy_to_xywh(np.asarray(dt_boxes_xyxy)[dv]),
            "dt_scores": np.asarray(dt_scores)[dv],
            "dt_classes": np.asarray(dt_classes)[dv],
            "gt_boxes": self._xyxy_to_xywh(np.asarray(gt_boxes_xyxy)[gv]),
            "gt_classes": np.asarray(gt_classes)[gv],
        }
        self.per_image_bbox.append(rec)
        if dt_masks is not None and gt_masks is not None:
            seg = dict(rec)
            seg["dt_rles"] = [rle_mod.encode(np.asarray(m) >= 0.5)
                              for m, s in zip(dt_masks, dv) if s]
            seg["gt_rles"] = [rle_mod.encode(np.asarray(m) >= 0.5)
                              for m, s in zip(gt_masks, gv) if s]
            # Segm area ranges use MASK areas (pycocotools ann['area']).
            seg["dt_areas"] = np.array([rle_mod.area(r)
                                        for r in seg["dt_rles"]], np.float64)
            seg["gt_areas"] = np.array([rle_mod.area(r)
                                        for r in seg["gt_rles"]], np.float64)
            self.per_image_segm.append(seg)

    def summarize(self) -> Dict[str, float]:
        out = {f"bbox/{k}": v for k, v in compute_ap(
            self.per_image_bbox, self.num_classes, "bbox").items()}
        if self.per_image_segm:
            out.update({f"segm/{k}": v for k, v in compute_ap(
                self.per_image_segm, self.num_classes, "segm").items()})
        return out
