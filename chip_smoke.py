"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero:
  1. device: name, count, torch and CUDA versions, nvidia-smi name and
     power limit;
  2. build: the CUDA kernels of mot3d_tpu_torch/csrc into build/kernels
     (nvcc time and the -Xptxas -v lines);
  3. K1 (kNN outlier statistic) against its plain version on every row at
     the main path's shapes and in full mode, with call times and the
     profiler's device times; then edge cases (k = 1, 7, 12, 32, C = 1 and
     2048, exact ties, detections with no valid points or candidates);
  4. K2 (pose point extraction) against its plain version at the main
     path's shapes, with call and device times, and at odd P with G = 33;
  5. the main path at full width: default Config() (R50-FPN with GN,
     256 x 320 input, 25-frame sequences, 16 detections per frame), random
     weights from --seed, one warm-up and three timed synthetic sequences
     through `make_sequence_infer_step`; per-stage times, K1 launches;
  6. the same sequences with pose.extraction="pallas" (K2 on the path), and
     the pose stage of both extraction modes compared on one sequence's
     detections;
  7. one sequence of the main path under torch.profiler (device time by
     kernel, device idle share);
  8. K3 (exact NMS) against its plain version: adversarial cases (ties,
     chains, invalid rows, odd K) and the evaluation path's shapes, with
     times;
  9. the reference-parity evaluation path at full width: the detector in
     import mode (`import_config`: affine norms, stride on the 1x1, torch
     voxel reshape, anchor offset 0) with exact NMS (K3 on the path),
     random weights and affine parameters from --seed, one warm-up and
     three timed sequences through `make_sequence_infer_step`, then one
     device-to-host copy, `Tracker.assemble`, GT trajectories and MOTA on
     the host; one further sequence with the NOCS bin head; a host-only
     oracle sequence whose MOTA must be 1; one sequence under the profiler;
 10. both paths in turns (default, evaluation, evaluation, default), to
     compare their frames/s inside one process;
 11. combined training at full width through `CombinedTrainer.train`
     (windows of 2 frames of a synthetic sequence with masks, voxels and
     NOCS ramps; gates open): 3 warm-up and 10 timed steps (median ms per
     step, peak memory, K1 launches per step, finite losses, a non-zero
     tracking loss, both models updated), one step under the profiler, K1
     on the training path's own inputs against its plain version, the
     NOCS head's gradient from the tracking loss alone (non-zero with
     `pose.differentiable=True`, exactly 0 detached), one step at the
     untouched default config and a checkpoint save -> restore -> step;
then the kernels line (with each kernel's launches on the training path),
the nvidia-smi line and the final status line.
Run it from the root of a checkout (it imports mot3d_tpu_torch from
there) on a machine with a CUDA device; without one it exits with code 2.
With --kernels-only it stops after phase 4: copied into another checkout
and run from there, it times that checkout's K1 and K2 the same way.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (data sheet)
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s (data sheet)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / iters


def kernel_device_ms(fn, name: str, iters: int = 10) -> dict:
    """Per-launch device time (ms) of each CUDA kernel whose name contains
    `name`, from torch.profiler over `iters` calls of fn (after one
    warm-up call): {kernel name: ms}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    return {e.key: e.self_device_time_total / 1e3 / e.count
            for e in prof.key_averages() if name in e.key}


def bound_ms(ops: float, nbytes: float):
    t_ops, t_bytes = ops / H100_FP32_FLOPS, nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ------------------------------------------------------------------ phases


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})
    return smi[0] if smi else "nvidia-smi gave no output"


def phase_build():
    from mot3d_tpu_torch.ops.cuda.build import build
    res = build()
    emit({"phase": "build", "seconds": round(res.seconds, 2),
          "cached": res.cached, "ptxas": list(res.ptxas)})


def _clouds(rng, b, n, dev):
    """Per detection: a dense cluster, a few far outliers and padding."""
    pts = rng.normal(size=(b, n, 3)).astype(np.float32) * 0.1
    pts[:, : n // 40] *= 30.0
    pts += rng.uniform(-2, 2, (b, 1, 3)).astype(np.float32)
    valid = np.ones((b, n), bool)
    n_valid = rng.integers(n // 4, n + 1, b)
    valid &= np.arange(n)[None] < n_valid[:, None]
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev))


def _knn_cases(rng, dev):
    """(name, points, valid, cols, k): the compiled top-k widths that the
    path's shapes (k = 5, 20) do not reach (k = 1, 7, 12, 32), C = 1 and
    C = 2048, duplicated points whose distances tie exactly, detections
    whose points or candidates are all invalid or that have fewer than k
    valid candidates."""
    def subset(n, c):
        return (np.arange(c) * n + n // 2) // c

    def case(name, n, cols, k, b=8, pts=None, valid=None):
        p, v = _clouds(rng, b, n, dev)
        if pts is not None:
            p = torch.from_numpy(pts.astype(np.float32)).to(dev)
        if valid is not None:
            v = torch.from_numpy(valid).to(dev)
        return (name, p, v, torch.tensor(cols, dtype=torch.int32,
                                         device=dev), k)

    yield case("k1_subset", 1024, subset(1024, 256), 1)
    yield case("k7_full", 512, np.arange(512), 7)
    yield case("k12_full", 512, np.arange(512), 12)
    yield case("k32_full", 1024, np.arange(1024), 32)
    yield case("c1", 256, [10], 1)
    yield case("c2048", 2048, np.arange(2048), 20)
    # Multiples of 1/16 below 3: d2 is exact, duplicates sit at exactly 0
    # and equal distances tie exactly.
    dup = np.repeat(rng.integers(-48, 48, (8, 256, 3)) / 16.0, 4, axis=1)
    yield case("duplicates", 1024, np.arange(1024), 5, pts=dup)
    yield case("duplicates_subset", 1024, subset(1024, 256), 5, pts=dup)
    cols = subset(1024, 256)
    deg = np.ones((4, 1024), bool)
    deg[0] = False                       # every point invalid
    deg[1, cols] = False                 # every candidate invalid
    deg[2, cols[3:]] = False             # 3 valid candidates, k = 5
    yield case("degenerate_detections", 1024, cols, 5, b=4, valid=deg)


def _knn_compare(k1, pts, valid, cols, k, what):
    """K1 against its plain version on every row (invalid rows are 0 in
    both) and the kept masks after the threshold; returns the error."""
    from mot3d_tpu_torch.config import PoseConfig
    from mot3d_tpu_torch.geometry.outlier import _threshold_keep

    p = PoseConfig()
    got = k1.knn_mean_dists(pts, valid, cols, k)
    want = k1.knn_mean_dists_plain(pts, valid, cols, k)
    sync()
    err = float((got - want).abs().max())
    keep_g = _threshold_keep(got, valid, p.outlier_std_ratio,
                             p.outlier_min_points)
    keep_w = _threshold_keep(want, valid, p.outlier_std_ratio,
                             p.outlier_min_points)
    mism = int((keep_g != keep_w).sum())
    check(err <= 1e-5, f"K1 {what}: mean-kNN error {err}")
    check(mism == 0, f"K1 {what}: {mism} kept-mask mismatches")
    check(bool(torch.isfinite(got).all()), f"K1 {what}: non-finite")
    return err, mism


def phase_k1(rng, dev, b=400):
    from mot3d_tpu_torch.config import PoseConfig
    from mot3d_tpu_torch.geometry.outlier import candidate_columns
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1

    p = PoseConfig()
    n = p.max_points
    result = {}
    for mode, cand in (("subset", p.outlier_candidates), ("full", 0)):
        pts, valid = _clouds(rng, b, n, dev)
        cols, k = candidate_columns(n, cand, p.outlier_nb_neighbors, dev)
        valid[0, cols.long()] = False          # every candidate invalid
        valid[1] = False                        # fewer than k valid
        valid[1, cols[: k - 2].long()] = True
        valid[1, :5] = True
        err, mism = _knn_compare(k1, pts, valid, cols, k, mode)
        ms = cuda_time_ms(lambda: k1.knn_mean_dists(pts, valid, cols, k), 20)
        dev_ms = sum(kernel_device_ms(
            lambda: k1.knn_mean_dists(pts, valid, cols, k),
            "knn_mean_dists").values())
        plain_ms = cuda_time_ms(
            lambda: k1.knn_mean_dists_plain(pts, valid, cols, k), 5, 1)
        # Work this data needs: valid rows x valid non-self candidates,
        # ~10 fp32 operations per pair; bytes: each input and output once.
        colv = valid[:, cols.long()]
        pairs = float((valid.sum(1) * colv.sum(1)).sum())
        nbytes = pts.numel() * 4 + valid.numel() + cols.numel() * 4 + b * n * 4
        bms, by = bound_ms(10 * pairs, nbytes)
        result[mode] = dict(max_abs_err=err, kept_mismatches=mism, ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by,
                            shape=[b, n, int(cols.numel()), k],
                            valid_pairs=pairs)
        emit({"phase": "k1", "mode": mode, **result[mode]})
    cases = {}
    for name, pts, valid, cols, k in _knn_cases(rng, dev):
        cases[name] = _knn_compare(k1, pts, valid, cols, k, name)[0]
    emit({"phase": "k1", "mode": "cases", "max_abs_err": cases})
    return result["subset"]


def _k2_inputs(rng, dev, s, t, p, h, w):
    """Slots' NOCS and mask patches, boxes partly outside the image, and
    depth frames with 10% holes."""
    x0 = rng.uniform(-20, w - 20, s)
    y0 = rng.uniform(-20, h - 20, s)
    boxes = np.stack([x0, y0, x0 + rng.uniform(8, 160, s),
                      y0 + rng.uniform(8, 120, s)], 1).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, (t, h, w)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (
        rng.uniform(0, 1, (s, p, p, 3)).astype(np.float32),
        rng.uniform(0, 1, (s, p, p)).astype(np.float32), boxes, depth)]


def _k2_compare(k2, args, intr, g, what):
    from mot3d_tpu_torch.pose.extraction import grid_extract

    feats, valid = k2.pose_extract(*args, intr, g)
    feats_w, valid_w = grid_extract(*args, intr, g)
    sync()
    check(bool((valid == valid_w).all()), f"K2 {what}: valid differs")
    err = float((feats - feats_w).abs().max())
    check(err <= 2e-5, f"K2 {what}: feats error {err}")
    return feats, valid, err


def phase_k2(rng, dev, cfg):
    from mot3d_tpu_torch.ops.cuda import pose_extract as k2
    from mot3d_tpu_torch.pose.extraction import grid_extract

    t, i = cfg.tracking.seq_len, cfg.detection.detections_per_image
    h, w, g, p = cfg.camera.height, cfg.camera.width, 32, 28
    s = t * i
    args = _k2_inputs(rng, dev, s, t, p, h, w)
    cam = cfg.camera
    intr = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                         [0, 0, 1.0]], dtype=torch.float32, device=dev)
    feats, valid, err = _k2_compare(k2, args, intr, g, "path shapes")
    ms = cuda_time_ms(lambda: k2.pose_extract(*args, intr, g), 50)
    dev_ms = sum(kernel_device_ms(lambda: k2.pose_extract(*args, intr, g),
                                  "pose_extract").values())
    plain_ms = cuda_time_ms(lambda: grid_extract(*args, intr, g), 10)
    nbytes = (sum(a.numel() for a in args) * 4 + 36
              + feats.numel() * 4 + valid.numel())
    # ~60 fp32 operations per sample (weights, 2x2 taps for 4 channels,
    # backprojection).
    bms, by = bound_ms(60.0 * s * g * g, nbytes)
    # Odd P (per-thread staging) and G = 33 (a ragged last round, output
    # rows that are not 16-byte aligned).
    odd = _k2_compare(k2, _k2_inputs(rng, dev, 64, 4, 27, h, w), intr, 33,
                      "P = 27, G = 33")[2]
    res = dict(max_abs_err=max(err, odd), ms=ms, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               shape=[s, g * g, p, h, w],
               valid_frac=float(valid.float().mean()),
               odd_case_max_abs_err=odd)
    emit({"phase": "k2", **res})
    return res


def _nms_boxes(rng, shape, size=(8.0, 200.0), extent=(320.0, 256.0)):
    """Random XYXY boxes clipped to the padded image, like RPN proposals."""
    wh = rng.uniform(*size, shape + (2,))
    ctr = rng.uniform(0, 1, shape + (2,)) * np.array(extent)
    lim = np.array(extent * 2)
    return np.clip(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1), 0,
                   lim).astype(np.float32)


def _nms_cases(rng):
    """(name, boxes (..., K, 4), scores, valid, threshold): inputs that
    break a wrong exact NMS.  Unsorted; ties, chains, invalid rows, odd K."""
    def case(name, boxes, scores=None, valid=None, thresh=0.5):
        shape = boxes.shape[:-1]
        if scores is None:
            scores = rng.uniform(size=shape)
        if valid is None:
            valid = np.ones(shape, bool)
        return (name, boxes.astype(np.float32), scores.astype(np.float32),
                valid, thresh)

    k = 130
    slide = np.arange(k, dtype=np.float32)[:, None] * np.float32([4, 0, 4, 0])
    chain = np.float32([0, 0, 10, 10]) + slide    # i overlaps i + 1 only
    yield case("chain_depth_k", chain, np.linspace(1, 0, k), thresh=0.4)
    yield case("identical_boxes", np.tile(np.float32([3, 4, 50, 60]), (k, 1)))
    yield case("tied_scores", _nms_boxes(rng, (k,)),
               np.round(rng.uniform(size=k), 1))
    yield case("all_scores_equal", _nms_boxes(rng, (k,)), np.zeros(k))
    some = rng.uniform(size=(3, 200)) < 0.7
    yield case("invalid_rows", _nms_boxes(rng, (3, 200)), valid=some,
               thresh=0.4)
    yield case("all_invalid", _nms_boxes(rng, (2, 70)),
               valid=np.zeros((2, 70), bool))
    yield case("k_equals_1", _nms_boxes(rng, (4, 1)))
    yield case("k_65", _nms_boxes(rng, (2, 65)), thresh=0.7)
    # Integer corners: many IoUs are exactly equal to each other and sit on
    # or next to simple fractions such as 2/5 and 7/10.
    lo = rng.integers(0, 12, (4, 300, 2))
    grid = np.concatenate([lo, lo + rng.integers(1, 8, (4, 300, 2))], -1)
    for thr in (0.4, 0.7):
        yield case(f"integer_corners_{thr}", grid, thresh=thr,
                   valid=rng.uniform(size=(4, 300)) < 0.9)
    yield case("batch_dims", _nms_boxes(rng, (2, 3, 129)), thresh=0.7)
    # K above what the mask needs of shared memory: the global scratch.
    yield case("k_1500_global_scratch", _nms_boxes(rng, (2, 1500)),
               thresh=0.7)


def phase_k3(rng, dev, cfg):
    """K3 against its plain version: the adversarial cases through
    `nms_mask` (sort, kernel, unsort) against the sort-free fixpoint, then
    score-sorted problems at the shapes of the evaluation path."""
    from mot3d_tpu_torch.models.rpn import level_slices
    from mot3d_tpu_torch.ops import nms as nms_ops
    from mot3d_tpu_torch.ops.cuda import nms as k3

    cases = 0
    for name, boxes, scores, valid, thr in _nms_cases(rng):
        args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, valid)]
        before = k3.launches.count
        got = nms_ops.nms_mask(*args, thr, exact=True)
        want = nms_ops.nms_mask_plain(*args, thr, exact=True)
        sync()
        check(k3.launches.count == before + 1, f"K3 {name}: no launch")
        mism = int((got != want).sum())
        check(mism == 0, f"K3 {name}: {mism} kept-mask mismatches")
        cases += 1

    det, t = cfg.detection, cfg.tracking.seq_len
    rpn_k = [min(det.rpn_pre_nms_topk_test, s1 - s0) for s0, s1 in
             level_slices(det.pad_height, det.pad_width,
                          len(det.anchor_ratios))]
    shapes = [(t, k, det.rpn_nms_thresh) for k in rpn_k]
    shapes.append((t * det.num_classes, det.rpn_post_nms_topk_test,
                   det.nms_thresh_test))
    total = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, with_sort_ms=0.0,
                 ops=0.0, nbytes=0.0, kept=0)
    per_shape = []
    for q, k, thr in shapes:
        size = (8.0, 200.0) if thr == det.rpn_nms_thresh else (8.0, 120.0)
        boxes = torch.from_numpy(_nms_boxes(rng, (q, k), size)).to(dev)
        scores = torch.from_numpy(
            np.sort(rng.uniform(size=(q, k)).astype(np.float32))[:, ::-1]
            .copy()).to(dev)
        valid = torch.from_numpy(rng.uniform(size=(q, k)) < 0.9).to(dev)
        got = k3.nms_sorted(boxes, valid, thr)
        want = k3.nms_sorted_plain(boxes, valid, thr)
        sync()
        mism = int((got != want).sum())
        check(mism == 0, f"K3 {q} x {k}: {mism} kept-mask mismatches")
        ms = cuda_time_ms(lambda: k3.nms_sorted(boxes, valid, thr), 20)
        plain_ms = cuda_time_ms(
            lambda: k3.nms_sorted_plain(boxes, valid, thr), 2, 1)
        sort_ms = cuda_time_ms(
            lambda: nms_ops.nms_mask(boxes, scores, valid, thr), 20)
        # Work this data needs: every pair of valid boxes of a problem once,
        # ~14 fp32 operations per pair; bytes: 16 + 1 in and 1 out per box.
        nv = valid.sum(1).double()
        ops = 14.0 * float((nv * (nv - 1) / 2).sum())
        nbytes = 18.0 * q * k
        # The call's two kernels apart, from the profiler's device times.
        per_kernel = kernel_device_ms(
            lambda: k3.nms_sorted(boxes, valid, thr), "nms_", 5)
        split = {name: t for key, t in per_kernel.items()
                 for name in ("nms_pairs_kernel", "nms_scan_kernel")
                 if name in key}
        per_shape.append({"problems": q, "k": k, "thresh": thr, "ms": ms,
                          "kernel_ms": split,
                          "plain_ms": plain_ms, "with_sort_ms": sort_ms,
                          "bound_ms": bound_ms(ops, nbytes)[0],
                          "kept": int(got.sum())})
        for key, val in (("ms", ms), ("device_ms", sum(split.values())),
                         ("plain_ms", plain_ms),
                         ("with_sort_ms", sort_ms), ("ops", ops),
                         ("nbytes", nbytes), ("kept", int(got.sum()))):
            total[key] += val
    bms, by = bound_ms(total["ops"], total["nbytes"])
    res = dict(max_abs_err=0.0, kept_mismatches=0, ms=total["ms"],
               device_ms=total["device_ms"], plain_ms=total["plain_ms"],
               with_sort_ms=total["with_sort_ms"],
               bound_ms=bms, bound_by=by)
    emit({"phase": "k3", "adversarial_cases": cases, **res,
          "what": "one sequence's 6 launches (5 RPN levels, 1 class-wise); "
                  "bound counts valid pairs x 14 operations against 18 "
                  "bytes per box; the serial rank chain of each problem, "
                  "not the pair work, is the likely floor",
          "per_launch": per_shape})
    return res


def _sequence(rng, cfg, cam_x=0.0):
    """One synthetic 25-frame sequence: a room (tilted floor-to-wall depth)
    with four box-shaped objects, a camera that pans slowly, and the
    objects' GT 2D boxes, world 3D boxes and identities."""
    det, cam = cfg.detection, cfg.camera
    t, m = cfg.tracking.seq_len, det.max_instances
    h, w = cam.height, cam.width
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    objs = [(rng.uniform(0.06, 0.7) * w, rng.uniform(0.08, 0.6) * h,
             rng.uniform(0.12, 0.28) * w, rng.uniform(0.16, 0.33) * h,
             rng.uniform(1.5, 3.0)) for _ in range(min(4, m))]
    images = np.zeros((t, det.pad_height, det.pad_width, 3), np.float32)
    depth = np.zeros((t, h, w), np.float32)
    campose = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1))
    boxes2d = np.zeros((t, m, 4), np.float32)
    boxes3d = np.zeros((t, m, 8, 3), np.float32)
    gt_valid = np.zeros((t, m), bool)
    signs = np.array([[1, 1, 1], [1, 1, -1], [-1, 1, -1], [-1, 1, 1],
                      [1, -1, 1], [1, -1, -1], [-1, -1, -1], [-1, -1, 1]],
                     np.float32)
    for f in range(t):
        shift = 0.005 * w * f
        d = 4.0 - 1.5 * vv / h + 0.002 * uu
        img = rng.uniform(40, 90, (h, w, 3))
        campose[f, 0, 3] = 0.02 * f + cam_x
        for j, (x, y, bw, bh, z) in enumerate(objs):
            x0, y0 = int(x - shift), int(y)
            x1, y1 = int(x0 + bw), int(y0 + bh)
            if x1 <= 0:
                continue
            x0 = max(x0, 0)
            d[y0:y1, x0:x1] = z + 0.001 * (uu[y0:y1, x0:x1] - x0)
            img[y0:y1, x0:x1] = 60 + 40 * j
            boxes2d[f, j] = [x0, y0, x1, y1]
            zs = d[y0:y1, x0:x1]
            us, vs = uu[y0:y1, x0:x1], vv[y0:y1, x0:x1]
            pts = np.stack([(us - cam.cx) / cam.fx * zs,
                            -((vs - cam.cy) / cam.fy * zs), -zs], -1)
            world = pts.reshape(-1, 3) + campose[f, :3, 3]
            lo, hi = world.min(0), world.max(0)
            boxes3d[f, j] = (lo + hi) / 2 + signs * (hi - lo) / 2
            gt_valid[f, j] = True
        depth[f] = d
        images[f, :h] = img
    ids = np.tile(np.arange(m, dtype=np.int32), (t, 1))
    return dict(images=images, depth=depth, campose=campose,
                gt_boxes2d=boxes2d, gt_valid2d=gt_valid, gt_boxes3d=boxes3d,
                gt_boxes3d_cropped=boxes3d, gt_ids=ids, gt_valid=gt_valid)


def _batch(seqs, idx):
    from mot3d_tpu_torch.parallel.infer_step import SequenceBatch
    return SequenceBatch(**{k: np.stack([seqs[idx][k]]) for k in seqs[idx]})


def _run_staged(stepper, seqs, draws, q):
    """One sequence stage by stage, with a synchronise after each stage."""
    batch = _batch(seqs, q)
    seq = type(batch)(*(x[0] for x in batch))
    times = {}
    t0 = time.perf_counter()
    dets = stepper.detect(seq.images)
    sync()
    times["detector_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = stepper.pose(dets, seq, draws[q, 0])
    sync()
    times["pose_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    probs, obj_ids = stepper.track(frames, seq)
    sync()
    times["graph_mpn_s"] = time.perf_counter() - t0
    return dets, frames, probs, obj_ids, times


def phase_main(seed, cfg, dev):
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.models.mpn import TrackerModel
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1
    from mot3d_tpu_torch.ops.cuda import pose_extract as k2
    from mot3d_tpu_torch.parallel.infer_step import make_sequence_infer_step
    from mot3d_tpu_torch.tracking.graph_builder import make_template

    det_c, trk_c, pose_c = cfg.detection, cfg.tracking, cfg.pose
    torch.manual_seed(seed)
    det = MaskRCNN(det_c, device=dev)
    trk = TrackerModel(cfg.graph, device=dev)
    template = make_template(trk_c.seq_len, det_c.detections_per_image,
                             trk_c.max_frame_dist)
    step = make_sequence_infer_step(det, trk, template, cfg, device=dev)
    rng = np.random.default_rng(seed)
    seqs = [_sequence(rng, cfg, 0.1 * q) for q in range(4)]
    draws = rng.integers(0, 2 ** 31 - 1, (4, 1, trk_c.seq_len,
                                          det_c.detections_per_image,
                                          pose_c.ransac_iters,
                                          pose_c.ransac_sample_size))
    draws = torch.from_numpy(draws)

    _run_staged(step, seqs, draws, 0)            # warm-up
    # Correctness of the composed step on the warm-up sequence.
    out = step(_batch(seqs, 0), draws=draws[0])
    t, i = trk_c.seq_len, det_c.detections_per_image
    check(tuple(out.translations.shape) == (1, t, i, 3), "output shape")
    check(tuple(out.edge_probs.shape) == (1, len(template.src_frame)),
          "edge_probs shape")
    sync()
    torch.cuda.reset_peak_memory_stats()

    k1.launches.reset()
    k2.launches.reset()
    stage = {"detector_s": 0.0, "pose_s": 0.0, "graph_mpn_s": 0.0}
    t0 = time.perf_counter()
    results = []
    for q in (1, 2, 3):
        dets, frames, probs, obj_ids, times = _run_staged(step, seqs,
                                                          draws, q)
        for key in stage:
            stage[key] += times[key]
        results.append((dets, frames, probs))
    total = time.perf_counter() - t0
    launches = {"knn_outlier": k1.launches.count,
                "pose_extract": k2.launches.count}
    for dets, frames, probs in results:
        check(bool(torch.isfinite(frames.translations).all()),
              "non-finite translations")
        check(bool(torch.isfinite(probs).all()), "non-finite edge probs")
        check(bool(((probs >= 0) & (probs <= 1)).all()), "edge probs range")
    check(launches["knn_outlier"] == 2 * 3,
          f"K1 launched {launches['knn_outlier']} times, expected 6")
    from mot3d_tpu_torch.config import Config
    res = {"phase": "main_path",
           "config": "default Config()" if cfg == Config() else "custom",
           "sequences": 3, "frames": 3 * t,
           "stage_s": stage, "total_s": total,
           "sequences_per_s": 3 / total, "frames_per_s": 3 * t / total,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "valid_detections": int(sum(int(r[1].valid.sum())
                                       for r in results)),
           "detector_valid": int(sum(int(r[0].valid.sum())
                                     for r in results))}
    emit(res)
    return det, trk, template, seqs, draws, launches, step


def phase_pallas(cfg, det, trk, template, seqs, draws, dev):
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1
    from mot3d_tpu_torch.ops.cuda import pose_extract as k2
    from mot3d_tpu_torch.parallel.infer_step import make_sequence_infer_step

    cfg_p = cfg.replace(pose=dataclasses.replace(cfg.pose,
                                                 extraction="pallas"))
    step_g = make_sequence_infer_step(det, trk, template, cfg, device=dev)
    step_p = make_sequence_infer_step(det, trk, template, cfg_p, device=dev)
    step_p(_batch(seqs, 0), draws=draws[0])     # warm-up
    sync()
    k1.launches.reset()
    k2.launches.reset()
    t0 = time.perf_counter()
    for q in (1, 2, 3):
        out = step_p(_batch(seqs, q), draws=draws[q])
        check(bool(torch.isfinite(out.translations).all()),
              "pallas path: non-finite translations")
    sync()
    total = time.perf_counter() - t0
    launches = {"knn_outlier": k1.launches.count,
                "pose_extract": k2.launches.count}
    check(launches["pose_extract"] == 3,
          f"K2 launched {launches['pose_extract']} times, expected 3")

    # Both extraction modes on the same detections: the pose outputs of
    # every slot, gated or not.
    batch = _batch(seqs, 1)
    seq = type(batch)(*(x[0] for x in batch))
    dets = step_g.detect(seq.images)
    fg = step_g.pose(dets, seq, draws[1, 0])
    fp = step_p.pose(dets, seq, draws[1, 0])
    sync()
    check(bool((fg.valid == fp.valid).all()), "grid/pallas valid differ")
    err_t = float((fg.translations - fp.translations).abs().max())
    err_s = float((fg.scales - fp.scales).abs().max())
    check(err_t <= 1e-4 and err_s <= 1e-4,
          f"grid/pallas pose differ: translations {err_t}, scales {err_s}")
    res = {"phase": "pallas_extraction", "sequences": 3, "total_s": total,
           "frames_per_s": 3 * cfg.tracking.seq_len / total,
           "launches": launches, "grid_vs_pallas_translation_err": err_t,
           "grid_vs_pallas_scale_err": err_s}
    emit(res)
    return launches


def phase_profile(cfg, det, trk, template, seqs, draws, dev, top=15,
                  path="main_path"):
    """One sequence of a path under torch.profiler: device time by kernel,
    and the device's busy share of the sequence's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from mot3d_tpu_torch.parallel.infer_step import make_sequence_infer_step

    step = make_sequence_infer_step(det, trk, template, cfg, device=dev)
    batch = _batch(seqs, 1)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, draws=draws[1])
        sync()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    emit({"phase": "profile", "path": path, "wall_s": wall,
          "device_busy_s": busy,
          "device_idle_share": 1.0 - busy / wall,
          "kernel_launches": int(sum(e.count for e in events)),
          "top": [{"name": e.key[:90], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in events[:top]]})


def _randomise_affine(model, seed):
    """Random, non-trivial scales and biases for every frozen-affine norm
    layer (a fresh one is the identity)."""
    from mot3d_tpu_torch.models.norms import AffineChannelNorm
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, AffineChannelNorm):
                n = m.weight.numel()
                m.weight.copy_(1.5 + 0.2 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))


def _gt_tracks(tracker, seq):
    """GT trajectories of one synthetic sequence (class 0, location = box
    centre)."""
    valid = seq["gt_valid"]
    return tracker.gt_trajectories(seq["gt_ids"], valid,
                                   seq["gt_boxes3d"].mean(-2),
                                   np.zeros(valid.shape, np.int64))


def _host_oracle(tracker, template, seq, cfg):
    """Host layer alone, at the full template: detections equal to the GT
    objects and oracle edges must assemble into the GT tracks, MOTA 1."""
    t, i = cfg.tracking.seq_len, cfg.detection.detections_per_image
    m = seq["gt_valid"].shape[1]
    det_valid = np.zeros((t, i), bool)
    det_valid[:, :m] = seq["gt_valid"]
    obj_ids = np.full((t, i), -1, np.int64)
    obj_ids[:, :m] = np.where(seq["gt_valid"], seq["gt_ids"], -1)
    trans = np.zeros((t, i, 3))
    trans[:, :m] = seq["gt_boxes3d"].mean(-2)
    same = (obj_ids[template.src_frame, template.src_slot]
            == obj_ids[template.dst_frame, template.dst_slot])
    pred = tracker.assemble(template, same.astype(np.float64), obj_ids,
                            det_valid, trans, np.zeros((t, i), np.int64))
    summary = tracker.evaluate(pred, _gt_tracks(tracker, seq))
    check(summary["num_objects"] > 0 and summary["mota"] == 1.0
          and summary["idf1"] == 1.0,
          f"host oracle: MOTA {summary['mota']}, IDF1 {summary['idf1']}")
    return summary


def phase_eval(seed, cfg, trk, template, seqs, draws, dev):
    """The reference-parity evaluation path: import-mode detector with
    exact NMS -> pose -> graph -> MPN -> host assembly -> MOTA."""
    from mot3d_tpu_torch.evaluator.edge_metrics import \
        edge_precision_recall_f1
    from mot3d_tpu_torch.importers.flax_params import import_config
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1
    from mot3d_tpu_torch.ops.cuda import nms as k3
    from mot3d_tpu_torch.parallel.infer_step import (SequenceOutputs,
                                                     make_sequence_infer_step,
                                                     outputs_to_host)
    from mot3d_tpu_torch.tracking.mot_metrics import (accumulated_idf1,
                                                      accumulated_mota)
    from mot3d_tpu_torch.tracking.tracker import Tracker

    det_c = dataclasses.replace(import_config(cfg.detection), fast_nms=False)
    cfg_e = cfg.replace(detection=det_c)
    torch.manual_seed(seed + 1)
    det = MaskRCNN(det_c, device=dev)
    _randomise_affine(det, seed)
    step = make_sequence_infer_step(det, trk, template, cfg_e, device=dev)
    tracker = Tracker(cfg.tracking)
    t = cfg.tracking.seq_len
    e = len(template.src_frame)

    def host(frames, probs, obj_ids, q):
        t0 = time.perf_counter()
        out = outputs_to_host(SequenceOutputs(
            probs, obj_ids, frames.valid, frames.translations,
            frames.classes, frames.objectness))
        pred = tracker.assemble(template, out.edge_probs[:e], out.obj_ids,
                                out.valid, out.translations, out.classes)
        summary, _ = tracker.evaluate(pred, _gt_tracks(tracker, seqs[q]),
                                      classwise=True)
        return out, pred, summary, time.perf_counter() - t0

    _run_staged(step, seqs, draws, 0)            # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    k1.launches.reset()
    k3.launches.reset()
    stage = {"detector_s": 0.0, "pose_s": 0.0, "graph_mpn_s": 0.0,
             "host_assembly_s": 0.0}
    summaries, n_traj, valid_dets = [], 0, 0
    t0 = time.perf_counter()
    for q in (1, 2, 3):
        dets, frames, probs, obj_ids, times = _run_staged(step, seqs, draws,
                                                          q)
        out, pred, summary, times["host_assembly_s"] = host(
            frames, probs, obj_ids, q)
        for key in stage:
            stage[key] += times[key]
        check(bool(np.isfinite(out.translations).all()),
              "eval path: non-finite translations")
        check(bool(np.isfinite(out.edge_probs).all())
              and bool(((out.edge_probs >= 0) & (out.edge_probs <= 1)).all()),
              "eval path: edge probabilities outside [0, 1]")
        check(all(np.isfinite(v) for v in summary.values()),
              "eval path: non-finite MOTA summary")
        check(bool(torch.isfinite(dets.boxes).all()
                   and torch.isfinite(dets.nocs).all()),
              "eval path: non-finite detections")
        summaries.append(summary)
        n_traj += len(pred)
        valid_dets += int(dets.valid.sum())
    total = time.perf_counter() - t0
    launches = {"knn_outlier": k1.launches.count, "nms": k3.launches.count}
    check(launches["nms"] == 6 * 3,
          f"K3 launched {launches['nms']} times, expected 18 (5 RPN levels "
          "+ 1 class-wise per sequence)")
    check(launches["knn_outlier"] == 2 * 3,
          f"K1 launched {launches['knn_outlier']} times, expected 6")
    mota = accumulated_mota(summaries)
    check(np.isfinite(mota), "eval path: non-finite accumulated MOTA")

    # The composed step on one sequence must equal the staged run.
    composed = outputs_to_host(step(_batch(seqs, 3), draws=draws[3]))
    check(np.array_equal(composed.edge_probs[0, :e], out.edge_probs[:e])
          and np.array_equal(composed.valid[0], out.valid),
          "eval path: composed step differs from its stages")
    # Edge metrics of the last sequence against the identity targets.
    src = out.obj_ids[template.src_frame, template.src_slot]
    dst = out.obj_ids[template.dst_frame, template.dst_slot]
    edges = edge_precision_recall_f1(
        out.edge_probs[:e], (src == dst) & (src >= 0),
        mask=(out.valid[template.src_frame, template.src_slot]
              & out.valid[template.dst_frame, template.dst_slot]),
        threshold=cfg.tracking.edge_threshold)

    # One further sequence with the NOCS bin head.
    bin_c = dataclasses.replace(det_c, nocs_use_bin_loss=True)
    torch.manual_seed(seed + 2)
    det_b = MaskRCNN(bin_c, device=dev)
    _randomise_affine(det_b, seed)
    step_b = make_sequence_infer_step(det_b, trk, template,
                                      cfg.replace(detection=bin_c),
                                      device=dev)
    dets_b, frames_b, probs_b, obj_b, _ = _run_staged(step_b, seqs, draws, 1)
    bins = dets_b.nocs * (bin_c.nocs_num_bins - 1)
    check(bool(torch.isfinite(frames_b.translations).all())
          and bool(torch.isfinite(probs_b).all()),
          "NOCS bin head: non-finite outputs")
    check(float((bins - bins.round()).abs().max()) < 1e-4
          and float(dets_b.nocs.min()) >= 0 and float(dets_b.nocs.max()) <= 1,
          "NOCS bin head: values are not bin centres in [0, 1]")
    _, _, summary_b, _ = host(frames_b, probs_b, obj_b, 1)

    oracle = _host_oracle(tracker, template, seqs[1], cfg)
    emit({"phase": "eval_path",
          "config": "import_config(Config().detection), fast_nms=False",
          "sequences": 3, "frames": 3 * t, "stage_s": stage,
          "total_s": total, "sequences_per_s": 3 / total,
          "frames_per_s": 3 * t / total,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "nms_launches_per_sequence":
          launches["nms"] // 3, "detector_valid": valid_dets,
          "trajectories": n_traj, "accumulated_mota": mota,
          "accumulated_idf1": accumulated_idf1(summaries),
          "summary_last": summaries[-1], "edge_metrics_last": edges,
          "nocs_bins": {"distinct_values": int(bins.round().unique().numel()),
                        "mota": summary_b["mota"]},
          "host_oracle": {"mota": oracle["mota"],
                          "num_objects": oracle["num_objects"]}})
    phase_profile(cfg_e, det, trk, template, seqs, draws, dev,
                  path="eval_path")
    return launches, step


def phase_turns(steps, seqs, draws, frames):
    """Both paths in turns inside one process (default, evaluation,
    evaluation, default), three sequences each through the composed step:
    the host's clock drifts between phases, so only this compares them."""
    passes = []
    for name in ("main_path", "eval_path", "eval_path", "main_path"):
        sync()
        t0 = time.perf_counter()
        for q in (1, 2, 3):
            steps[name](_batch(seqs, q), draws=draws[q])
        sync()
        passes.append({"path": name,
                       "frames_per_s": 3 * frames
                       / (time.perf_counter() - t0)})
    emit({"phase": "turns", "passes": passes})


def _train_frames(rng, cfg, cam_x=0.0):
    """One synthetic sequence of `_sequence` as training frames: each
    object also gets its mask (its 2D box), a 32^3 solid-box voxel grid
    and a 28 x 28 NOCS coordinate ramp with a class, as the JAX package's
    `data/synthetic_detection.py` draws them (copied here, not imported).
    Identities are rolled by one per frame, as `__graft_entry__.py` rolls
    them: every cross-frame edge is then a negative, so the balanced BCE
    has pos_weight 1 and a non-zero value."""
    from mot3d_tpu_torch.data.samples import DetectionSample

    seq = _sequence(rng, cfg, cam_x)
    det = cfg.detection
    t, m = seq["gt_valid2d"].shape
    ramp = np.linspace(0.1, 0.9, 28, dtype=np.float32)
    nocs = np.stack([np.tile(ramp, (28, 1)), np.tile(ramp[:, None], (1, 28)),
                     np.full((28, 28), 0.5, np.float32)], -1)
    classes = (np.arange(m) % det.num_classes).astype(np.int32)
    voxels = np.zeros((m, 32, 32, 32), np.float32)
    for j, c in enumerate(classes):
        d = 8 + 2 * (c % 6)
        voxels[j, 4:4 + d, 4:28, 6:26] = 1.0
    frames = []
    for f in range(t):
        masks = np.zeros((m, det.pad_height, det.pad_width), np.float32)
        for j, (x0, y0, x1, y1) in enumerate(seq["gt_boxes2d"][f]):
            if seq["gt_valid2d"][f, j]:
                masks[j, int(y0):int(y1), int(x0):int(x1)] = 1.0
        frames.append(DetectionSample(
            image=seq["images"][f], depth=seq["depth"][f],
            campose=seq["campose"][f], boxes=seq["gt_boxes2d"][f],
            classes=classes, valid=seq["gt_valid2d"][f], masks=masks,
            voxels=voxels, nocs=np.repeat(nocs[None], m, 0),
            boxes3d=seq["gt_boxes3d"][f],
            object_ids=np.roll(np.arange(m, dtype=np.int32), f),
            locations=seq["gt_boxes3d"][f].mean(-2),
            rotations=np.zeros((m, 3), np.float32),
            scales3d=np.ones(m, np.float32)))
    return frames


def _open_train_gates(cfg):
    """Every gate open, as `__graft_entry__.py:140-144` opens them, so each
    detection slot of the random-weight detector flows through pose into
    the graph (with closed gates the tracking loss is identically 0); the
    detector's own 0.05 score gate too, since a few updates push the
    random classifier's foreground scores under it."""
    return cfg.replace(
        detection=dataclasses.replace(cfg.detection, score_thresh_test=-1.0),
        combined=dataclasses.replace(cfg.combined, objectness_thres=-1.0,
                                     iou2d_thres=-1.0),
        pose=dataclasses.replace(cfg.pose, min_inlier_ratio=0.0),
        tracking=dataclasses.replace(cfg.tracking, box_iou_thres=0.0))


def _trainer(cfg, out_dir, dev):
    """A CombinedTrainer whose mask predictor passes the 0.5 extraction
    threshold: with torch's initialisation every mask logit of the random
    detector is below 0, so no point would reach the pose fit."""
    from mot3d_tpu_torch.train.combined_trainer import CombinedTrainer

    tr = CombinedTrainer(cfg, out_dir, device=dev)
    with torch.no_grad():
        tr.det_model.mask_head.Conv_4.bias.fill_(3.0)
    return tr


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _changed(model, before) -> bool:
    return any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def _profile_train_step(tr, window, top=12, shapes=False):
    """One `CombinedTrainer.train` step under torch.profiler: device busy
    and idle share of its wall time and the top kernels; with `shapes`,
    the top aten operators by the device time of the kernels they launch,
    with their input shapes (recording them slows the host, so that step's
    idle share is not the step's own)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        tr.train(iter([window]), max_iter=tr.state.step + 1)
        sync()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    res = {"wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall,
           "kernel_launches": int(sum(e.count for e in events)),
           "top": [{"name": e.key[:90], "count": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                   for e in events[:top]]}
    if shapes:
        ops = [e for e in prof.key_averages(group_by_input_shape=True)
               if e.key.startswith("aten::") and e.device_time_total > 0]
        ops.sort(key=lambda e: e.device_time_total, reverse=True)
        res["top_ops"] = [{"op": e.key, "shapes": str(e.input_shapes)[:120],
                           "count": e.count,
                           "device_ms": e.device_time_total / 1e3}
                          for e in ops[:top]]
    return res


def phase_train(seed, cfg, dev, warmup=3, timed=10):
    """End-to-end combined training at full width through
    `CombinedTrainer.train`: windows of combined.batch_size = 2 frames,
    detached pose, joint_grad, remat (the trainer's defaults), open gates;
    then one step at the untouched default config, the differentiable pose
    (the NOCS head's gradient from the tracking loss alone), K1 on the
    training path's own inputs against its plain version, and a
    save -> restore -> step round trip through CheckpointManager."""
    import shutil

    from mot3d_tpu_torch.geometry import outlier
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1
    from mot3d_tpu_torch.ops.cuda import nms as k3
    from mot3d_tpu_torch.ops.cuda import pose_extract as k2
    from mot3d_tpu_torch.parallel.train_step import (CombinedBatch,
                                                     make_combined_train_step,
                                                     make_window_draws)
    from mot3d_tpu_torch.train.checkpoints import CheckpointManager
    from mot3d_tpu_torch.train.combined_trainer import \
        samples_to_combined_window

    work = "build/chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    # Training runs at cuDNN's default algorithm choice, as a user's run
    # does; main() pins deterministic algorithms for the kernel phases.
    torch.backends.cudnn.deterministic = False
    cfg_o = _open_train_gates(cfg)
    rng = np.random.default_rng(seed + 10)
    frames = _train_frames(rng, cfg_o)
    t = cfg.combined.batch_size
    windows = [frames[i:i + t] for i in range(len(frames) - t + 1)]
    check(len(windows) >= warmup + timed + 6, "too few training windows")

    torch.manual_seed(seed)
    tr = _trainer(cfg_o, f"{work}/open", dev)
    det0, trk0 = _params(tr.det_model), _params(tr.trk_model)
    tr.train(iter(windows[:warmup]), max_iter=warmup)
    sync()
    torch.cuda.reset_peak_memory_stats()
    step_ms, k1_per_step, losses = [], [], []
    for w in windows[warmup:warmup + timed]:
        k1.launches.reset()
        k2.launches.reset()
        k3.launches.reset()
        sync()
        t0 = time.perf_counter()
        metrics = tr.train(iter([w]), max_iter=tr.state.step + 1)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        k1_per_step.append(k1.launches.count)
        check(k2.launches.count == 0 and k3.launches.count == 0,
              "train: K2 or K3 launched at the default extraction and NMS")
        check(all(np.isfinite(v) for v in metrics.values()),
              f"train: non-finite losses {metrics}")
        losses.append(metrics)
    peak = torch.cuda.max_memory_allocated()
    # Remat recomputes the window forward in the backward: K1 runs twice
    # in the forward (depth cloud, NOCS cloud) and twice again there.
    check(all(n == 4 for n in k1_per_step),
          f"train: K1 launches per step {k1_per_step}, expected 4")
    check(all(m["tracking_loss"] > 0 for m in losses),
          "train: the tracking loss is 0 with open gates")
    check(_changed(tr.det_model, det0) and _changed(tr.trk_model, trk0),
          "train: a parameter set did not change")

    # One step under the profiler at cuDNN's default (non-deterministic)
    # algorithm choice, as a user's run gets it, and one with the
    # deterministic algorithms the earlier phases pin.
    profile_res = _profile_train_step(tr, windows[warmup + timed])
    profile_ops = _profile_train_step(tr, windows[warmup + timed + 1], top=8,
                                      shapes=True)
    torch.backends.cudnn.deterministic = True
    profile_det = _profile_train_step(tr, windows[warmup + timed + 2], top=3)
    torch.backends.cudnn.deterministic = False

    # K1 on the training path's own inputs (the depth and the NOCS cloud of
    # one window: T * I = 32 rows x 1024 points, 256 candidates, k = 5).
    seen = []
    orig = outlier.knn_mean_dists

    def record(pts, val, cols, k):
        seen.append((pts.clone(), val.clone(), cols.clone(), k))
        return orig(pts, val, cols, k)

    tmpl = tr.window_template
    step_d = make_combined_train_step(tr.det_model, tr.trk_model, tmpl, cfg_o,
                                      remat=False, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    win = samples_to_combined_window(windows[-1])
    draws = make_window_draws(tr.det_model, cfg_o, 1, t, gen)
    one = type(draws)(type(draws.detection)(*(x[0] for x in draws.detection)),
                      draws.ransac[0])
    outlier.knn_mean_dists = record
    try:
        step_d.window_forward(win, one)
    finally:
        outlier.knn_mean_dists = orig
    check(len(seen) == 2, f"train: K1 called {len(seen)} times per forward")
    k1_train = []
    for pts, val, cols, k in seen:
        got = k1.knn_mean_dists(pts, val, cols, k)
        want = k1.knn_mean_dists_plain(pts, val, cols, k)
        sync()
        err = float((got - want).abs().max())
        check(err == 0.0, f"train: K1 differs from its plain version by {err}")
        k1_train.append({"shape": list(pts.shape) + [int(cols.numel()), k],
                         "valid_points": int(val.sum()),
                         "max_abs_err": err})

    # The differentiable pose: d(tracking loss)/d(NOCS head), on one window.
    nocs_params = list(tr.det_model.nocs_head.parameters())
    grad_abs = {}
    for diff in (False, True):
        cfg_x = cfg_o.replace(pose=dataclasses.replace(cfg_o.pose,
                                                       differentiable=diff))
        step_x = make_combined_train_step(tr.det_model, tr.trk_model, tmpl,
                                          cfg_x, device=dev)
        _, tl = step_x.window_forward(win, one)
        grads = torch.autograd.grad(tl, nocs_params, allow_unused=True)
        vals = [float(g.abs().sum()) for g in grads if g is not None]
        check(all(np.isfinite(v) for v in vals),
              "train: non-finite NOCS-head gradient")
        grad_abs[diff] = sum(vals)
    check(grad_abs[False] == 0.0,
          f"train: detached pose leaks {grad_abs[False]} into the NOCS head")
    check(grad_abs[True] > 0.0,
          "train: no gradient from the tracking loss into the NOCS head")
    # ... and one update with it.
    step_x(tr.state, CombinedBatch(*(x[None] for x in win)), generator=gen)
    check(all(bool(torch.isfinite(p).all())
              for p in tr.det_model.parameters()),
          "train: non-finite detector after a differentiable-pose step")

    # One step at the untouched default config (closed gates).
    torch.manual_seed(seed + 1)
    tr_d = _trainer(cfg, f"{work}/default", dev)
    m_default = tr_d.train(iter(windows[:1]), max_iter=1)
    check(all(np.isfinite(v) for v in m_default.values()),
          "train: non-finite losses at the default config")

    # save -> restore -> one more step.
    mgr = CheckpointManager(f"{work}/ckpt")
    saved_step = tr.state.step
    check(mgr.save(saved_step, tr.state), "train: checkpoint not saved")
    det_s, trk_s = _params(tr.det_model), _params(tr.trk_model)
    tr.train(iter([windows[-2]]), max_iter=tr.state.step + 1)
    check(_changed(tr.det_model, det_s), "train: no update after the save")
    mgr.restore(tr.state)
    check(tr.state.step == saved_step and not _changed(tr.det_model, det_s)
          and not _changed(tr.trk_model, trk_s),
          "train: restore did not give the saved state back")
    m_after = tr.train(iter([windows[-2]]), max_iter=tr.state.step + 1)
    check(all(np.isfinite(v) for v in m_after.values()),
          "train: non-finite losses after the restore")
    shutil.rmtree(work, ignore_errors=True)
    torch.backends.cudnn.deterministic = True

    res = {"phase": "train",
           "config": "default Config(), gates open; windows of 2 frames",
           "warmup_steps": warmup, "timed_steps": timed,
           "median_ms_per_step": float(np.median(step_ms)),
           "ms_per_step": step_ms,
           "max_memory_allocated_bytes": peak,
           "k1_launches_per_step": k1_per_step,
           "last_metrics": losses[-1],
           "tracking_loss": [m["tracking_loss"] for m in losses],
           "profile": profile_res,
           "top_ops": profile_ops["top_ops"],
           "profile_cudnn_deterministic": profile_det,
           "k1_training_inputs": k1_train,
           "nocs_head_grad_abs_sum": {"detached": grad_abs[False],
                                      "differentiable": grad_abs[True]},
           "default_config_step": m_default,
           "checkpoint": {"saved_step": saved_step, "restored": True,
                          "next_step_metrics": m_after}}
    emit(res)
    return {"knn_outlier": sum(k1_per_step), "pose_extract": 0, "nms": 0,
            "steps": timed}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="run the device, build, K1 and K2 phases and stop "
                         "(no status line): to time one checkout's kernels "
                         "beside another's in one session")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from mot3d_tpu_torch.config import Config  # fails outside the checkout

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    cfg = Config()
    smi = phase_device()
    phase_build()
    k1_res = phase_k1(rng, dev)
    k2_res = phase_k2(rng, dev, cfg)
    if args.kernels_only:
        return 0
    det, trk, template, seqs, draws, main_launches, main_step = \
        phase_main(args.seed, cfg, dev)
    pallas_launches = phase_pallas(cfg, det, trk, template, seqs, draws, dev)
    phase_profile(cfg, det, trk, template, seqs, draws, dev)
    k3_res = phase_k3(rng, dev, cfg)
    eval_launches, eval_step = phase_eval(args.seed, cfg, trk, template, seqs,
                                          draws, dev)
    phase_turns({"main_path": main_step, "eval_path": eval_step}, seqs, draws,
                cfg.tracking.seq_len)
    train_launches = phase_train(args.seed, cfg, dev)

    kernels = [
        {"name": "knn_outlier", "route": "cuda",
         "source": "mot3d_tpu_torch/csrc/knn_outlier.cu",
         "replaces": "mot3d_tpu/ops/pallas/knn_outlier.py:84",
         "launches": main_launches["knn_outlier"],
         "max_abs_err": k1_res["max_abs_err"], "ms": k1_res["ms"],
         "device_ms": k1_res["device_ms"],
         "plain_ms": k1_res["plain_ms"], "bound_ms": k1_res["bound_ms"],
         "bound_by": k1_res["bound_by"], "library_ms": None,
         "train_launches": train_launches["knn_outlier"]},
        {"name": "pose_extract", "route": "cuda",
         "source": "mot3d_tpu_torch/csrc/pose_extract.cu",
         "replaces": "mot3d_tpu/ops/pallas/pose_extract.py:129",
         "launches": pallas_launches["pose_extract"],
         "launches_path": "main path with pose.extraction='pallas'",
         "max_abs_err": k2_res["max_abs_err"], "ms": k2_res["ms"],
         "device_ms": k2_res["device_ms"],
         "plain_ms": k2_res["plain_ms"], "bound_ms": k2_res["bound_ms"],
         "bound_by": k2_res["bound_by"], "library_ms": None,
         "train_launches": train_launches["pose_extract"]},
        {"name": "nms", "route": "cuda",
         "source": "mot3d_tpu_torch/csrc/nms.cu",
         "replaces": "mot3d_tpu/ops/pallas/nms_kernel.py:81",
         "launches": eval_launches["nms"],
         "launches_path": "evaluation path (import mode, fast_nms=False)",
         "max_abs_err": k3_res["max_abs_err"], "ms": k3_res["ms"],
         "device_ms": k3_res["device_ms"],
         "plain_ms": k3_res["plain_ms"], "bound_ms": k3_res["bound_ms"],
         "bound_by": k3_res["bound_by"], "library_ms": None,
         "train_launches": train_launches["nms"]},
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
