"""A data-parallel dry run on N ranks (counterpart of
`__graft_entry__.dryrun_multichip`).

    python -m mot3d_tpu_torch.parallel.dryrun N [--device cpu]

spawns N ranks joined over torch.distributed at a localhost rendezvous
(on the GPUs by default, with the backend rule of `multihost.backend_for`;
gloo on the CPU with `--device cpu`), and on each:

  1. the full combined step (detection losses, pose, graph, tracking loss,
     two AdamW updates) on the tiny config, the batch of N windows sharded
     one per rank, with every gate open and the GT identities rolled per
     frame, so the tracking loss is a real one (`__graft_entry__.py:
     131-205`);
  2. the sharded tracking step on N synthetic sequences.

It checks what the JAX dry run checks: finite metrics, `step == 1`, and a
non-zero tracking loss in both steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mot3d_tpu_torch.config import (CameraConfig, Config, DetectionConfig,
                                    PoseConfig, TrackingConfig)
from mot3d_tpu_torch.device import resolve_device


def tiny_config() -> Config:
    """The JAX dry run's tiny configuration (`__graft_entry__.py:
    _tiny_config`): 64 x 64 frames, a quarter-width backbone, 2-frame
    windows of 4 detections."""
    det = DetectionConfig(
        pad_height=64, pad_width=64, image_height=64, image_width=64,
        rpn_pre_nms_topk_train=128, rpn_post_nms_topk_train=32,
        rpn_pre_nms_topk_test=64, rpn_post_nms_topk_test=16,
        roi_batch_per_image=16, detections_per_image=4, max_instances=3,
        anchor_sizes=(16, 32, 64, 128, 256),
        backbone_width=0.25, fpn_channels=64,
        mask_head_width=32, box_head_width=128, head_width_mult=0.125,
        fg_head_buffer=8)
    trk = TrackingConfig(seq_len=2, max_instances_per_frame=4,
                         max_frame_dist=1)
    cam = CameraConfig(height=64, width=64, fx=64.0, fy=64.0)
    pose = PoseConfig(max_points=128, ransac_iters=16,
                      outlier_min_points=16)
    return Config().replace(detection=det, tracking=trk, camera=cam,
                            pose=pose)


def open_gates(cfg: Config) -> Config:
    """Every gate open, as `__graft_entry__.py:140-144` opens them
    (objectness, 2D IoU, RANSAC inlier ratio, the GT identity's 3D IoU), so
    that every detection slot of a random detector flows through pose into
    the graph: with closed gates the tracking loss of random weights is 0.
    The detector's own 0.05 score gate too, since a few updates push a
    random classifier's foreground scores under it."""
    return cfg.replace(
        detection=dataclasses.replace(cfg.detection, score_thresh_test=-1.0),
        combined=dataclasses.replace(cfg.combined, objectness_thres=-1.0,
                                     iou2d_thres=-1.0),
        pose=dataclasses.replace(cfg.pose, min_inlier_ratio=0.0),
        tracking=dataclasses.replace(cfg.tracking, box_iou_thres=0.0))


def dryrun_batch(cfg: Config, windows: int, seed: int = 0) -> dict:
    """The JAX dry run's windows as numpy arrays (leading axis = window):
    random pixels and depth, one 20 x 20 GT box per instance with a full
    mask, random voxels, NOCS and 3D boxes, and the GT identities rolled
    by one per frame (every cross-frame edge a negative: the balanced BCE
    then has pos_weight 1 and a non-zero value)."""
    det = cfg.detection
    b, t, m, h = windows, cfg.tracking.seq_len, det.max_instances, \
        det.pad_height
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, t, m, 4), np.float32)
    boxes[..., 2:] = 20.0
    ids = np.stack([np.roll(np.arange(m, dtype=np.int32), f)
                    for f in range(t)])
    return dict(
        images=rng.uniform(0, 255, (b, t, h, h, 3)).astype(np.float32),
        depth=rng.uniform(1, 3, (b, t, h, h)).astype(np.float32),
        campose=np.tile(np.eye(4, dtype=np.float32), (b, t, 1, 1)),
        gt_boxes2d=boxes, gt_classes=np.zeros((b, t, m), np.int32),
        gt_valid=np.ones((b, t, m), bool),
        gt_masks=np.ones((b, t, m, h, h), bool),
        gt_voxels=rng.uniform(size=(b, t, m, 32, 32, 32)) < 0.3,
        gt_nocs=rng.uniform(size=(b, t, m, 28, 28, 3)).astype(np.float32),
        gt_boxes3d=rng.normal(size=(b, t, m, 8, 3)).astype(np.float32),
        gt_ids=np.repeat(ids[None], b, 0))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _finite(metrics: dict) -> dict:
    out = {k: float(v) for k, v in sorted(metrics.items())}
    _check(all(np.isfinite(v) for v in out.values()),
           f"non-finite metrics {out}")
    return out


def _rank(rank: int, n: int, port: int, device: str, results) -> None:
    """One rank of the dry run (a spawned process)."""
    from mot3d_tpu_torch.data.synthetic import synthetic_sequence
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.models.mpn import TrackerModel
    from mot3d_tpu_torch.parallel.mesh import make_mesh, replicate, \
        shard_batch
    from mot3d_tpu_torch.parallel.multihost import init_distributed
    from mot3d_tpu_torch.parallel.train_step import (
        CombinedBatch, CombinedTrainState, TrackingTrainState,
        make_combined_train_step, make_tracking_train_step)
    from mot3d_tpu_torch.tracking.graph_builder import make_template
    from mot3d_tpu_torch.train.combined_trainer import (adamw,
                                                        detection_optimizer,
                                                        tracking_optimizer)
    from mot3d_tpu_torch.train.schedules import warmup_multistep
    from mot3d_tpu_torch.train.tracking_trainer import sequences_to_batch

    torch.set_num_threads(1)
    dev = init_distributed(f"127.0.0.1:{port}", n, rank, device)
    try:
        mesh = make_mesh(device=dev)
        cfg = open_gates(tiny_config())
        det_c, trk_c = cfg.detection, cfg.tracking

        torch.manual_seed(0)
        det = MaskRCNN(det_c, device=dev)
        trk = TrackerModel(cfg.graph, device=dev)
        # torch's initialisation leaves every mask probability under the
        # 0.5 extraction threshold: no point would reach the pose fit.
        with torch.no_grad():
            det.mask_head.Conv_4.bias.fill_(3.0)
        replicate(mesh, det)
        replicate(mesh, trk)
        template = make_template(trk_c.seq_len, det_c.detections_per_image,
                                 trk_c.max_frame_dist)
        state = CombinedTrainState(det, *detection_optimizer(cfg, det),
                                   trk, *tracking_optimizer(cfg, trk))
        step = make_combined_train_step(det, trk, template, cfg, mesh=mesh)
        batch = shard_batch(mesh, CombinedBatch(**dryrun_batch(cfg, n)))
        gen = torch.Generator(device=dev).manual_seed(3)
        state, metrics = step(state, batch, generator=gen)
        combined = _finite(metrics)
        _check(state.step == 1, f"combined step count {state.step}")
        _check(combined["tracking_loss"] > 0,
               f"combined-step tracking loss not exercised: {combined}")

        tmpl2 = make_template(trk_c.seq_len, trk_c.max_instances_per_frame,
                              trk_c.max_frame_dist)
        seqs = [synthetic_sequence(trk_c, seed=i, num_objects=3,
                                   noise=0.01)._asdict() for i in range(n)]
        torch.manual_seed(9)
        trk2 = replicate(mesh, TrackerModel(cfg.graph, device=dev))
        tstate = TrackingTrainState(trk2, *adamw(
            trk2.parameters(), warmup_multistep(trk_c.learning_rate),
            trk_c.weight_decay))
        tstep = make_tracking_train_step(trk2, tmpl2, cfg, mesh=mesh)
        tstate, tmetrics = tstep(tstate, shard_batch(
            mesh, sequences_to_batch(seqs)))
        tracking = _finite(tmetrics)
        _check(tstate.step == 1, f"tracking step count {tstate.step}")
        _check(tracking["tracking_loss"] > 0,
               f"tracking loss not exercised: {tracking}")
        if rank == 0:
            results.put({"ranks": n, "backend": mesh.backend,
                         "device": str(dev), "combined": combined,
                         "tracking": tracking})
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A localhost TCP port that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, device=None) -> dict:
    """Run the dry run on `n` spawned ranks, each on its GPU unless
    `device="cpu"`; rank 0's metrics."""
    resolve_device(device)  # without a GPU: raise here, not in each rank
    results = mp.get_context("spawn").SimpleQueue()
    mp.spawn(_rank, args=(n, free_port(), device, results), nprocs=n,
             join=True)
    out = results.get()
    print(f"dryrun_multichip({n}): OK ({out['backend']}) — combined "
          f"metrics: {out['combined']} | sharded tracking step loss: "
          f"{out['tracking']['tracking_loss']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default=None,
                    help="cpu (gloo), or cuda, the default (one card per "
                         "rank: NCCL; ranks sharing a card: gloo)")
    args = ap.parse_args()
    dryrun_multichip(args.n, args.device)
