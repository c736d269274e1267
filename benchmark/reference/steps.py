"""The serving stages and the detection training step of the reference,
written out plainly (what `SequenceInferStep` and `DetectionTrainer`
compute, without their plumbing)."""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference.geometry.backproject import make_intrinsics
from benchmark.reference.models.mask_rcnn import GroundTruth
from benchmark.reference.pose.pipeline import postprocess_frames
from benchmark.reference.schedules import warmup_multistep
from benchmark.reference.tracking.graph_builder import build_graph


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on (the control's) or off (true float32) for matmuls and cuDNN
    over the extent; the previous settings are restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def true_fp32():
    return precision(False)


def _t(x, device, dtype=None):
    t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)


@torch.no_grad()
def detect(det, images, device):
    """(T, H, W, 3) pixels -> the detector's padded outputs (T, I, ...)."""
    det.eval()
    return det.predict(_t(images, device, torch.float32))


@torch.no_grad()
def pose(cfg, dets, seq: dict, draws, device):
    """Detections of one sequence (fields (T, I, ...)) -> gated poses
    (`FrameDetections`), with the sequence's RANSAC draws (T, I, iters,
    S)."""
    f = torch.float32
    cam = cfg.camera
    intr = make_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy, device)
    return postprocess_frames(
        _t(dets["boxes"], device, f), _t(dets["scores"], device, f),
        _t(dets["classes"], device, torch.int64),
        _t(dets["valid"], device, torch.bool), _t(dets["masks"], device, f),
        _t(dets["voxels"], device, f), _t(dets["nocs"], device, f),
        _t(seq["gt_boxes2d"], device, f),
        _t(seq["gt_valid2d"], device, torch.bool),
        _t(seq["depth"], device, f), _t(seq["campose"], device, f), intr,
        _t(seq["gt_boxes3d_cropped"], device, f), cfg, True,
        _t(draws, device, torch.int64))


@torch.no_grad()
def track(cfg, trk, template, frames: dict, seq: dict, device):
    """Poses of one sequence (fields (T, I, ...)) -> forward-edge
    probabilities (E,) and the GT identity of each detection (T, I)."""
    f = torch.float32
    trk.eval()
    graph = build_graph(template, cfg.tracking,
                        _t(frames["valid"], device, torch.bool),
                        _t(frames["translations"], device, f),
                        _t(frames["rotations"], device, f),
                        _t(frames["scales"], device, f),
                        _t(frames["pred_boxes"], device, f),
                        _t(seq["gt_boxes3d"], device, f),
                        _t(seq["gt_ids"], device, torch.int32),
                        _t(seq["gt_valid"], device, torch.bool))
    vox = _t(frames["voxels"], device, f)
    logits = trk(vox.reshape((-1,) + vox.shape[2:]), graph.src, graph.dst,
                 graph.edge_attr, graph.edge_mask)
    e = len(template.src_frame)
    return torch.sigmoid(logits[-1])[:e], graph.obj_ids


def detection_optimizer(cfg, model):
    """AdamW with the detector's schedule as a LambdaLR factor on a base LR
    of 1 (the optax update order gives the same step)."""
    c = cfg.combined
    opt = torch.optim.AdamW(model.parameters(), lr=1.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=c.detection_weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, warmup_multistep(
        c.detection_lr, c.lr_warmup_iters, c.lr_warmup_factor, c.lr_steps,
        c.lr_gamma))
    return opt, sched


def ground_truth(batch: dict, device) -> GroundTruth:
    f = torch.float32
    return GroundTruth(boxes=_t(batch["boxes"], device, f),
                       classes=_t(batch["classes"], device, torch.int64),
                       valid=_t(batch["valid"], device, torch.bool),
                       masks=_t(batch["masks"], device, f),
                       voxels=_t(batch["voxels"], device, f),
                       nocs=_t(batch["nocs"], device, f))


def train_step(det, opt, sched, batch: dict, draws, device) -> dict:
    """One detection training step: the sum of the `loss*` terms, its
    gradients (a parameter without one counts as zero) and one AdamW
    update.  Returns every term's value (float) and "total"."""
    det.train()
    opt.zero_grad(set_to_none=True)
    images = _t(batch["image"], device, torch.float32)
    losses = det.train_losses(images, ground_truth(batch, device), draws)
    total = sum(v for k, v in losses.items() if k.startswith("loss"))
    total.backward()
    for p in det.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    sched.step()
    out = {k: float(v.detach()) for k, v in losses.items()
           if k.startswith("loss")}
    out["total"] = float(total.detach())
    return out
