"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero:
  1. device: name, count, torch and CUDA versions, nvidia-smi name and
     power limit;
  2. build: the CUDA kernels of mot3d_tpu_torch/csrc into build/kernels
     (nvcc time and the -Xptxas -v lines);
  3. K1 (kNN outlier statistic) against its plain version at the main
     path's shapes, plus full mode and degenerate detections, with times;
  4. K2 (pose point extraction) against its plain version at the main
     path's shapes, with times;
  5. the main path at full width: default Config() (R50-FPN with GN,
     256 x 320 input, 25-frame sequences, 16 detections per frame), random
     weights from --seed, one warm-up and three timed synthetic sequences
     through `make_sequence_infer_step`; per-stage times, K1 launches;
  6. the same sequences with pose.extraction="pallas" (K2 on the path), and
     the pose stage of both extraction modes compared on one sequence's
     detections;
  7. one sequence of the main path under torch.profiler (device time by
     kernel, device idle share);
then the kernels line, the nvidia-smi line and the final status line.
Run it from the root of a checkout (it imports mot3d_tpu_torch from
there) on a machine with a CUDA device; without one it exits with code 2.
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


def phase_k1(rng, dev, b=400):
    from mot3d_tpu_torch.geometry.outlier import (_threshold_keep,
                                                  candidate_columns)
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1
    from mot3d_tpu_torch.config import PoseConfig

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
        got = k1.knn_mean_dists(pts, valid, cols, k)
        want = k1.knn_mean_dists_plain(pts, valid, cols, k)
        sync()
        err = float((got - want).abs()[valid].max())
        keep_g = _threshold_keep(got, valid, p.outlier_std_ratio,
                                 p.outlier_min_points)
        keep_w = _threshold_keep(want, valid, p.outlier_std_ratio,
                                 p.outlier_min_points)
        mism = int((keep_g != keep_w).sum())
        check(err <= 1e-5, f"K1 {mode}: mean-kNN error {err}")
        check(mism == 0, f"K1 {mode}: {mism} kept-mask mismatches")
        check(bool(torch.isfinite(got).all()), f"K1 {mode}: non-finite")
        ms = cuda_time_ms(lambda: k1.knn_mean_dists(pts, valid, cols, k), 20)
        plain_ms = cuda_time_ms(
            lambda: k1.knn_mean_dists_plain(pts, valid, cols, k), 5, 1)
        # Work this data needs: valid rows x valid non-self candidates,
        # ~10 fp32 operations per pair; bytes: each input and output once.
        colv = valid[:, cols.long()]
        pairs = float((valid.sum(1) * colv.sum(1)).sum())
        nbytes = pts.numel() * 4 + valid.numel() + cols.numel() * 4 + b * n * 4
        bms, by = bound_ms(10 * pairs, nbytes)
        result[mode] = dict(max_abs_err=err, kept_mismatches=mism, ms=ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            shape=[b, n, int(cols.numel()), k])
        emit({"phase": "k1", "mode": mode, **result[mode]})
    return result["subset"]


def phase_k2(rng, dev, cfg):
    from mot3d_tpu_torch.ops.cuda import pose_extract as k2
    from mot3d_tpu_torch.pose.extraction import grid_extract

    t, i = cfg.tracking.seq_len, cfg.detection.detections_per_image
    h, w, g, p = cfg.camera.height, cfg.camera.width, 32, 28
    s = t * i
    x0 = rng.uniform(-20, w - 20, s)
    y0 = rng.uniform(-20, h - 20, s)
    boxes = np.stack([x0, y0, x0 + rng.uniform(8, 160, s),
                      y0 + rng.uniform(8, 120, s)], 1).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, (t, h, w)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.uniform(0, 1, (s, p, p, 3)).astype(np.float32),
        rng.uniform(0, 1, (s, p, p)).astype(np.float32), boxes, depth)]
    cam = cfg.camera
    intr = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                         [0, 0, 1.0]], dtype=torch.float32, device=dev)
    feats, valid = k2.pose_extract(*args, intr, g)
    feats_w, valid_w = grid_extract(*args, intr, g)
    sync()
    check(bool((valid == valid_w).all()), "K2: valid differs")
    err = float((feats - feats_w).abs().max())
    check(err <= 2e-5, f"K2: feats error {err}")
    ms = cuda_time_ms(lambda: k2.pose_extract(*args, intr, g), 50)
    plain_ms = cuda_time_ms(lambda: grid_extract(*args, intr, g), 10)
    nbytes = (sum(a.numel() for a in args) * 4 + 36
              + feats.numel() * 4 + valid.numel())
    # ~60 fp32 operations per sample (weights, 2x2 taps for 4 channels,
    # backprojection).
    bms, by = bound_ms(60.0 * s * g * g, nbytes)
    res = dict(max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               shape=[s, g * g, p, h, w], valid_frac=float(valid.float()
                                                           .mean()))
    emit({"phase": "k2", **res})
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

    def run(stepper, q):
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

    run(step, 0)                                 # warm-up
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
        dets, frames, probs, obj_ids, times = run(step, q)
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
    return det, trk, template, seqs, draws, launches


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


def phase_profile(cfg, det, trk, template, seqs, draws, dev, top=15):
    """One sequence of the main path under torch.profiler: device time by
    kernel, and the device's busy share of the sequence's wall time."""
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
    emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy,
          "device_idle_share": 1.0 - busy / wall,
          "kernel_launches": int(sum(e.count for e in events)),
          "top": [{"name": e.key[:90], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in events[:top]]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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
    det, trk, template, seqs, draws, main_launches = \
        phase_main(args.seed, cfg, dev)
    pallas_launches = phase_pallas(cfg, det, trk, template, seqs, draws, dev)
    phase_profile(cfg, det, trk, template, seqs, draws, dev)

    kernels = [
        {"name": "knn_outlier", "route": "cuda",
         "source": "mot3d_tpu_torch/csrc/knn_outlier.cu",
         "replaces": "mot3d_tpu/ops/pallas/knn_outlier.py:67",
         "launches": main_launches["knn_outlier"],
         "max_abs_err": k1_res["max_abs_err"], "ms": k1_res["ms"],
         "plain_ms": k1_res["plain_ms"], "bound_ms": k1_res["bound_ms"],
         "bound_by": k1_res["bound_by"], "library_ms": None},
        {"name": "pose_extract", "route": "cuda",
         "source": "mot3d_tpu_torch/csrc/pose_extract.cu",
         "replaces": "mot3d_tpu/ops/pallas/pose_extract.py:102",
         "launches": pallas_launches["pose_extract"],
         "launches_path": "main path with pose.extraction='pallas'",
         "max_abs_err": k2_res["max_abs_err"], "ms": k2_res["ms"],
         "plain_ms": k2_res["plain_ms"], "bound_ms": k2_res["bound_ms"],
         "bound_by": k2_res["bound_by"], "library_ms": None},
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
