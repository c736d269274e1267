"""How `correct` is decided: what the timed path produced, judged against
the plain reference (`reference/`), which the benchmark runs in float32
with TF32 off on the inputs and weights it made from the seed.  Which of
the readings a cell compares, and their limits, are in its
`workloads/<cell>.json`.

Serving, per kept sequence, stage by stage:
- detector: the reference's `predict` on the same frames, independently.
  Detections are paired one to one within a frame and class by box IoU
  (at least `MATCH_IOU`, or every coordinate within `MATCH_PX`);
  `det_unmatched` is the share of the program's detections with no
  partner, `score_gap_p50` the median score gap of a pair (the scores the
  outputs carry), `masks_gap_p50`, `nocs_gap_p50` and `voxels_gap_p50`
  the median of a pair's mean gap of each head's probabilities;
  `far_share` the share of pairs in which any of these gaps exceeds the
  cell's `check.far` value for that output, so that one wrong slot among
  sixteen shows; `score_gap` and `head_gap` are the widest gaps;
- pose: the reference's pose stage on the program's detections and the
  same RANSAC draws (the reference follows the program from its
  detections, since a random detector's near-tied scores reorder its
  slots under any rounding); `pose_gap` is the widest translation gap
  (m) where both fits are valid, plus 1 for each slot whose validity
  differs;
- graph + MPN: the reference's graph and tracker on the program's poses;
  `edge_gap` is the widest edge-probability gap, plus 1 where the GT
  identities of the graph's nodes differ.

Training: the reference follows the first three steps from the same
weights, batches and sampler draws, taking the proposals the program
selected at each step (`train.reference_steps`).  `proposal_unmatched`
is the share of the program's step-1 proposals not among the reference's
own; `step<k>.<term>` the gap of a loss term at step k, and `loss_gap`
the widest, as a share of the larger of the term and the step's median
term; `grad_gap` the widest gap of a leaf's gradient norm at step 1 (the
program's worked out from AdamW's first moment) and `grad_gap_p50` the
median leaf's; `change_gap` the widest gap of a leaf's parameter change
after step 3; each leaf's gap as a share of the larger of its reference
norm and the median leaf's.  Leaves whose reference gradient is under
1e-3 of the median leaf's (a bias under a normalisation: nought up to
rounding, moved by Adam's round-off alone) are left out of
`change_gap`."""

from __future__ import annotations

import numpy as np
import torch

MATCH_IOU = 0.9
MATCH_PX = 1.0
ADAM_BETA1 = 0.9
SMALL_LEAF = 1e-3


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) XYXY -> (N, M)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)  # noqa
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def match(p_boxes, p_cls, p_ok, r_boxes, r_cls, r_ok):
    """One-to-one pairs (i, j) of a frame's detections: same class, box
    IoU >= MATCH_IOU or every coordinate within MATCH_PX (a box clipped to
    zero width at the border has no area), greedily by descending IoU."""
    iou = _iou(p_boxes, r_boxes)
    near = np.abs(p_boxes[:, None, :] - r_boxes[None, :, :]).max(-1)
    iou = np.where(near <= MATCH_PX, np.maximum(iou, MATCH_IOU), iou)
    iou[~(p_cls[:, None] == r_cls[None, :])] = -1
    iou[~p_ok] = -1
    iou[:, ~r_ok] = -1
    pairs = []
    order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None),
                                       iou.shape))[0]
    used_p, used_r = set(), set()
    for i, j in order:
        if iou[i, j] < MATCH_IOU:
            break
        if i in used_p or j in used_r:
            continue
        used_p.add(i)
        used_r.add(j)
        pairs.append((i, j))
    return pairs


def detector_pairs(prog: dict, out: dict, ref) -> dict:
    """prog: the program's detector outputs of one sequence (numpy,
    (T, I, ...)); out: its sequence outputs; ref: the reference's
    `Detections` (tensors).  The detections, the unmatched ones, and per
    pair the score gap and the mean gap of each head's output."""
    r = {k: v.detach().cpu().numpy() for k, v in ref._asdict().items()}
    acc = {"detections": 0, "unmatched": 0, "score": [], "masks": [],
           "nocs": [], "voxels": []}
    for f in range(prog["boxes"].shape[0]):
        ok = prog["valid"][f].astype(bool)
        pairs = match(prog["boxes"][f], out["classes"][f], ok,
                      r["boxes"][f], r["classes"][f],
                      r["valid"][f].astype(bool))
        acc["detections"] += int(ok.sum())
        acc["unmatched"] += int(ok.sum()) - len(pairs)
        for i, j in pairs:
            acc["score"].append(abs(float(out["scores"][f, i])
                                    - float(r["scores"][f, j])))
            for key in ("masks", "nocs", "voxels"):
                acc[key].append(float(np.abs(
                    prog[key][f, i].astype(np.float64) - r[key][f, j]).mean()))
    return acc


def pose_readings(out: dict, ref) -> dict:
    """The program's gated poses (its sequence outputs) against the
    reference's pose stage on the program's detections."""
    rv = ref.valid.cpu().numpy().astype(bool)
    pv = out["valid"].astype(bool)
    both = rv & pv
    gaps = np.zeros(0)
    if both.any():
        gaps = np.abs(out["translations"][both].astype(np.float64)
                      - ref.translations.cpu().numpy()[both]).max(-1)
    return {"gaps": gaps, "flips": int((rv != pv).sum()),
            "posed": int(pv.sum())}


def track_readings(out: dict, ref_probs, ref_ids) -> dict:
    gap = float(np.abs(out["edge_probs"].astype(np.float64)
                       - ref_probs.cpu().numpy()).max())
    ids_differ = not np.array_equal(out["obj_ids"], ref_ids.cpu().numpy())
    return {"edge_gap": gap + float(ids_differ)}


class Reference:
    """The configuration's reference detector, tracker and graph template
    on `device`, with the seed's weights."""

    def __init__(self, conf: dict, seed: int, device):
        from benchmark import common
        from benchmark.reference.tracking.graph_builder import make_template
        _, cfg, self.det, self.trk = common.reference_models(conf, device)
        self.cfg = cfg
        w_det, w_trk = common.model_weights(conf, seed, device)
        self.det.load_state_dict(w_det)
        self.trk.load_state_dict(w_trk)
        self.template = make_template(cfg.tracking.seq_len,
                                      cfg.detection.detections_per_image,
                                      cfg.tracking.max_frame_dist)
        self.device = device


def sequence_parts(ref: Reference, inputs, kept: dict,
                   pose_tf32: bool = False, track_tf32: bool = False) -> dict:
    """What one kept sequence contributes to the readings: the detector's
    pairs, the pose gaps and the edge gap.  `inputs` are the sequence and
    its draws, `kept` the program's outputs of it; `pose_tf32` /
    `track_tf32` put the reference computed in TF32 in the program's place
    for that stage (the control)."""
    from benchmark.reference import steps
    from benchmark.reference.ops import precision

    seq, draws = inputs
    cfg, dev = ref.cfg, ref.device
    prog_out = {k: np.asarray(v)[0] for k, v in kept["out"].items()}
    with steps.true_fp32():
        ref_det = steps.detect(ref.det, seq["images"], dev)
        parts = detector_pairs(kept["detect"], prog_out, ref_det)
        del ref_det
        ref_pose = steps.pose(cfg, kept["detect"], seq, draws, dev)
    if pose_tf32:
        precision.TF32 = True
        try:
            ctl = steps.pose(cfg, kept["detect"], seq, draws, dev)
        finally:
            precision.TF32 = False
        prog_out["translations"] = ctl.translations.cpu().numpy()
        prog_out["valid"] = ctl.valid.cpu().numpy()
    parts.update(pose_readings(prog_out, ref_pose))
    frames = kept["pose"]
    with steps.true_fp32():
        probs, ids = steps.track(cfg, ref.trk, ref.template, frames, seq,
                                 dev)
    if track_tf32:
        with steps.precision(True):
            ctl, _ = steps.track(cfg, ref.trk, ref.template, frames, seq,
                                 dev)
        prog_out["edge_probs"] = ctl.cpu().numpy()
    parts.update(track_readings(prog_out, probs, ids))
    return parts


HEAD_KEYS = ("score", "masks", "nocs", "voxels")


def summarise(parts: list, far: dict) -> dict:
    """The readings over every kept sequence's parts: the share of
    unmatched detections over all of them, the median, 90th percentile
    and widest gaps of the detector's pairs, the share of pairs in which
    any output's gap exceeds its `far` value (a fault in one slot of
    sixteen moves a sixteenth of the pairs and no median), the widest
    pose and edge gaps, and the detections that reached the pose fit per
    sequence."""
    def cat(key):
        return np.concatenate([np.asarray(p[key], np.float64).reshape(-1)
                               for p in parts]) if parts else np.zeros(0)

    def stat(v, fn):
        return float(fn(v)) if v.size else 0.0
    n = sum(p["detections"] for p in parts)
    gaps, flips = cat("gaps"), sum(p["flips"] for p in parts)
    head = np.concatenate([cat("masks"), cat("nocs"), cat("voxels")])
    far_pairs = np.zeros(cat("score").size, bool)
    out = {"det_unmatched": sum(p["unmatched"] for p in parts) / max(n, 1),
           "head_gap": stat(head, np.max),
           "pose_gap": stat(gaps, np.max) + flips,
           "edge_gap": max((p["edge_gap"] for p in parts), default=0.0),
           "posed_per_sequence": sum(p["posed"] for p in parts)
           / max(len(parts), 1),
           "sequences_checked": len(parts)}
    for key in HEAD_KEYS:
        v = cat(key)
        out[f"{key}_gap_p50"] = stat(v, np.median)
        out[f"{key}_gap_p90"] = stat(v, lambda x: np.percentile(x, 90))
        far_pairs |= v > far[key]
    out["score_gap"] = stat(cat("score"), np.max)
    out["far_share"] = float(far_pairs.mean()) if far_pairs.size else 1.0
    return out


# ---------------------------------------------------------------- training

def leaf_norms(named: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            named.items()}


def first_grads(model, optimizer) -> dict:
    """Each leaf's gradient norm at the first step, worked out from AdamW's
    first moment after that step (m1 = (1 - beta1) g); 0 for a leaf the
    optimizer holds no moment of."""
    def moment(p):
        m = optimizer.state.get(p, {}).get("exp_avg")
        return torch.zeros_like(p) if m is None else m / (1 - ADAM_BETA1)
    return leaf_norms({n: moment(p) for n, p in model.named_parameters()})


def changes(model, before: dict) -> dict:
    return leaf_norms({n: p.detach() - before[n]
                       for n, p in model.named_parameters()})


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """{key: |prog - ref| / max(|ref|, median |ref| over keys)}."""
    keys = list(keys)
    med = float(np.median([abs(ref[k]) for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(abs(ref[k]), med, 1e-30)
            for k in keys}


def _worst(gaps: dict) -> tuple:
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def proposal_unmatched(prog, ref) -> float:
    """Share of the program's valid proposals of a step with no proposal
    of the reference's own selection at box IoU >= MATCH_IOU (or within
    MATCH_PX); 1 where their shapes differ."""
    pb, _, pv = (x.cpu().numpy() for x in prog)
    rb, _, rv = (x.cpu().numpy() for x in ref)
    if pb.shape != rb.shape:
        return 1.0
    n = unmatched = 0
    for i in range(pb.shape[0]):
        ok = pv[i].astype(bool)
        cls = np.zeros(pb.shape[1], np.int64)
        pairs = match(pb[i], cls, ok, rb[i], cls, rv[i].astype(bool))
        n += int(ok.sum())
        unmatched += int(ok.sum()) - len(pairs)
    return unmatched / max(n, 1)


def train_readings(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [per step {term: value}], "grads": {leaf:
    norm}, "changes": {leaf: norm}, "proposals": [per step (boxes,
    scores, valid)]}."""
    out = {"proposal_unmatched": proposal_unmatched(
        prog["proposals"][0], ref["proposals"][0])}
    loss_gap, loss_at = 0.0, ""
    for s, (lp, lr) in enumerate(zip(prog["losses"], ref["losses"])):
        gaps = _gaps(lp, lr, [k for k in lr if k.startswith("loss")])
        g, at = _worst(gaps)
        out[f"loss_gap_step{s + 1}"] = g
        for k, v in gaps.items():
            out[f"step{s + 1}.{k}"] = v
        if g > loss_gap:
            loss_gap, loss_at = g, f"step {s + 1} {at}"
    grads = ref["grads"]
    med = float(np.median(list(grads.values())))
    g = _gaps(prog["grads"], grads, grads)
    grad_gap, grad_at = _worst(g)
    moving = [k for k, v in grads.items() if v >= SMALL_LEAF * med]
    c = _gaps(prog["changes"], ref["changes"], moving)
    change_gap, change_at = _worst(c)
    out.update({"loss_gap": loss_gap, "grad_gap": grad_gap,
                "change_gap": change_gap,
                "grad_gap_p50": float(np.median(list(g.values()))),
                "loss_gap_at": loss_at, "grad_gap_at": grad_at,
                "change_gap_at": change_at,
                "leaves_left_out": len(grads) - len(moving)})
    return out
