"""Training steps, on one GPU or data-parallel over a mesh (counterpart of
`mot3d_tpu/parallel/train_step.py`).

Two steps mirror the reference's two training regimes:

  - tracking step (`Tracking/mpn_trainer.py:353-518`): a batch of padded
    sequence graphs, one AdamW update;
  - combined end-to-end step (`Detection/train_combined.py:481-569`): per
    window of consecutive frames, the detection losses, a second
    (eval-mode) detector pass, pose fitting, graph construction and the
    tracking loss, then two optimizers step independently.  The two
    detector passes share one backbone forward: the features are the same
    (GroupNorm and frozen affines keep no batch statistics), so the
    gradient is that of two separate passes.

With the parity-default detached pose (`pose.differentiable=False`,
reference `Detection/tracker/postprocess.py:151`) the tracking loss has no
path into the detector (the pose stage detaches its points, the voxels are
binarised), so the second pass runs without autograd.  With
`pose.differentiable=True` it records, and the tracking loss reaches the
NOCS head, the box head and the backbone through RANSAC/Umeyama.

In torch an optimizer holds its state beside the parameters it updates, so
the train states carry the models, the optimizers and their LR schedulers
(`CombinedTrainState.state_dict` is what a checkpoint holds).  Every random
number of a window (both detector samplers' uniforms and the RANSAC draws)
is an input, `WindowDraws`, made from an explicit `torch.Generator` unless
the caller passes them.

Data parallelism (`mesh=`, a `parallel/mesh.py:DataMesh`): each rank is
handed its own rows of the global batch (`shard_batch`), runs the step on
them, then every parameter gets a gradient (a missing one is zero),
`all_mean_grads` averages each model's gradients over the ranks in one
all_reduce, every rank makes the same update, and `all_mean` averages the
metrics.  The losses are means over windows or sequences, so with equal
shards this is the step on the global batch.  Draws a step makes itself
are the global batch's, from the generator in batch order, and each rank
keeps its rows: every rank's generator must be seeded alike.  The models
must start equal on every rank (`mesh.replicate`).  The reductions are
explicit rather than `DistributedDataParallel`'s hooks, which do not
follow `backward(inputs=...)` with `retain_graph` or a detector called
through both `train_losses` and an eval-mode `predict`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from mot3d_tpu_torch.config import Config
from mot3d_tpu_torch.geometry.backproject import make_intrinsics
from mot3d_tpu_torch.geometry.umeyama import make_draws
from mot3d_tpu_torch.models.mask_rcnn import (DetectionDraws, GroundTruth,
                                              MaskRCNN)
from mot3d_tpu_torch.models.mpn import TrackerModel, tracker_loss
from mot3d_tpu_torch.ops.cuda.pose_extract import NO_GRADIENT
from mot3d_tpu_torch.parallel.mesh import (DataMesh, all_mean,
                                           all_mean_grads, mesh_device,
                                           shard_batch)
from mot3d_tpu_torch.pose.pipeline import _check_extraction, \
    postprocess_frames
from mot3d_tpu_torch.tracking.graph_builder import GraphTemplate, build_graph


def _check_trainable(cfg: Config) -> None:
    """Refuse a configuration whose pose stage cannot be differentiated."""
    _check_extraction(cfg)
    if cfg.pose.extraction == "pallas":
        raise NotImplementedError(NO_GRADIENT)


def _zero_missing_grads(params) -> None:
    """optax updates every leaf, a zero gradient included (weight decay and
    the moments' decay still apply); torch.optim skips a parameter whose
    .grad is None, so give such parameters a zero gradient."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def update(model, optimizer, scheduler) -> None:
    """One optimizer step over every parameter (a missing gradient counts
    as zero, as in optax) and one schedule step."""
    _zero_missing_grads(model.parameters())
    optimizer.step()
    scheduler.step()


def _reduce_grads(mesh: Optional[DataMesh], *models) -> None:
    """Average every model's gradients over the mesh, a missing gradient
    counting as zero on every rank, so that all send the same tensors."""
    if mesh is None:
        return
    for model in models:
        params = list(model.parameters())
        _zero_missing_grads(params)
        all_mean_grads(mesh, params)


@dataclasses.dataclass
class ModelTrainState:
    """One model, its optimizer and LR scheduler, and the count of updates
    made; `state_dict` is what a checkpoint holds."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any            # torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": int(self.step)}

    def load_state_dict(self, sd: dict) -> None:
        for name in ("model", "optimizer", "scheduler"):
            getattr(self, name).load_state_dict(sd[name])
        self.step = int(sd["step"])


# ------------------------------------------------------------- tracking


class TrackingTrainState(ModelTrainState):
    """The tracker's train state."""


class TrackingBatch(NamedTuple):
    """Padded sequences, leading axis = batch."""

    det_valid: Any      # (B, T, I)
    translations: Any   # (B, T, I, 3)
    rotations: Any      # (B, T, I, 3)
    scales: Any         # (B, T, I)
    pred_boxes: Any     # (B, T, I, 8, 3)
    voxels: Any         # (B, T, I, 32, 32, 32)
    gt_boxes: Any       # (B, T, G, 8, 3)
    gt_ids: Any         # (B, T, G)
    gt_valid: Any       # (B, T, G)


def make_tracking_train_step(model: TrackerModel, template: GraphTemplate,
                             cfg: Config, device=None,
                             mesh: Optional[DataMesh] = None):
    """(state, batch) -> (state, metrics): the mean tracking loss of the
    batch's sequences, one backward, one update.  `device=None` means the
    GPU.  With a `mesh` the batch is this rank's rows of the global batch
    and the step is data-parallel (module docstring)."""
    _check_trainable(cfg)
    dev = mesh_device(device, mesh)
    model.to(dev)
    dtype = next(model.parameters()).dtype

    def seq_loss(seq: TrackingBatch):
        graph = build_graph(template, cfg.tracking, seq.det_valid,
                            seq.translations, seq.rotations, seq.scales,
                            seq.pred_boxes, seq.gt_boxes, seq.gt_ids,
                            seq.gt_valid)
        vox = seq.voxels.reshape((-1,) + tuple(seq.voxels.shape[-3:]))
        logits = model(vox, graph.src, graph.dst, graph.edge_attr,
                       graph.edge_mask)
        return tracker_loss(logits, graph.targets, graph.edge_mask)

    def step(state: TrackingTrainState, batch: TrackingBatch):
        batch = TrackingBatch(*(
            torch.as_tensor(x, device=dev).to(
                torch.bool if name in ("det_valid", "gt_valid") else
                torch.int32 if name == "gt_ids" else dtype)
            for name, x in zip(TrackingBatch._fields, batch)))
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.stack([
            seq_loss(TrackingBatch(*(x[b] for x in batch)))
            for b in range(batch.det_valid.shape[0])]).mean()
        loss.backward()
        _reduce_grads(mesh, state.model)
        update(state.model, state.optimizer, state.scheduler)
        state.step += 1
        metrics = {"tracking_loss": loss.detach()}
        return state, metrics if mesh is None else all_mean(mesh, metrics)

    return step


# ------------------------------------------------------------- combined


@dataclasses.dataclass
class CombinedTrainState:
    """Both models, their optimizers and LR schedulers, and the count of
    updates made."""

    det_model: MaskRCNN
    det_opt: torch.optim.Optimizer
    det_sched: Any
    trk_model: TrackerModel
    trk_opt: torch.optim.Optimizer
    trk_sched: Any
    step: int = 0

    def state_dict(self) -> dict:
        return {"det_model": self.det_model.state_dict(),
                "det_opt": self.det_opt.state_dict(),
                "det_sched": self.det_sched.state_dict(),
                "trk_model": self.trk_model.state_dict(),
                "trk_opt": self.trk_opt.state_dict(),
                "trk_sched": self.trk_sched.state_dict(),
                "step": int(self.step)}

    def load_state_dict(self, sd: dict) -> None:
        for name in ("det_model", "det_opt", "det_sched", "trk_model",
                     "trk_opt", "trk_sched"):
            getattr(self, name).load_state_dict(sd[name])
        self.step = int(sd["step"])


class CombinedBatch(NamedTuple):
    """A batch of sequence windows (leading axis B), as arrays or tensors
    on any device.  The reference uses windows of 2 consecutive frames of
    one sequence (`train_combined.py:88,481`).  images may be uint8 and
    gt_masks / gt_voxels bool: they travel compact and widen on the
    device."""

    images: Any        # (B, T, Hp, Wp, 3)
    depth: Any         # (B, T, H, W)
    campose: Any       # (B, T, 4, 4)
    gt_boxes2d: Any    # (B, T, M, 4)
    gt_classes: Any    # (B, T, M)
    gt_valid: Any      # (B, T, M)
    gt_masks: Any      # (B, T, M, Hp, Wp)
    gt_voxels: Any     # (B, T, M, 32, 32, 32)
    gt_nocs: Any       # (B, T, M, P, P, 3)
    gt_boxes3d: Any    # (B, T, M, 8, 3) world corner boxes
    gt_ids: Any        # (B, T, M)


class WindowDraws(NamedTuple):
    """Every random number of the combined step's windows (leading axes
    B, T): the detector's sampler uniforms and the raw RANSAC draws."""

    detection: DetectionDraws   # rpn (B, T, A), roi (B, T, P + M)
    ransac: torch.Tensor        # (B, T, I, iters, S)


def make_window_draws(det_model: MaskRCNN, cfg: Config, windows: int,
                      frames: int,
                      generator: Optional[torch.Generator] = None
                      ) -> WindowDraws:
    """Fresh draws for `windows` windows of `frames` frames, on the
    detector's device."""
    det = det_model.make_draws(windows * frames, generator)
    p = cfg.pose
    ransac = make_draws((windows, frames, cfg.detection.detections_per_image,
                         p.ransac_iters, p.ransac_sample_size), generator,
                        det_model.anchors.device)
    return WindowDraws(
        DetectionDraws(*(x.reshape((windows, frames) + x.shape[1:])
                         for x in det)), ransac)


def _window_draws(draws: WindowDraws, i: int) -> WindowDraws:
    return WindowDraws(DetectionDraws(*(x[i] for x in draws.detection)),
                       draws.ransac[i])


def _draws_to(draws: WindowDraws, device) -> WindowDraws:
    return WindowDraws(DetectionDraws(*(torch.as_tensor(x).to(device)
                                        for x in draws.detection)),
                       torch.as_tensor(draws.ransac).to(device))


_WIDE = {"gt_classes": torch.int64, "gt_ids": torch.int32,
         "gt_valid": torch.bool}


def _widen(batch: CombinedBatch, dtype, device) -> CombinedBatch:
    """Move a batch to the device and widen it there: uint8 images and
    bool masks / voxels become the models' float dtype."""
    return CombinedBatch(*(
        torch.as_tensor(x).to(device).to(_WIDE.get(name, dtype))
        for name, x in zip(CombinedBatch._fields, batch)))


def make_combined_train_step(det_model: MaskRCNN, trk_model: TrackerModel,
                             template: GraphTemplate, cfg: Config,
                             joint_grad: bool = True, remat: bool = True,
                             accum_windows: bool = False, device=None,
                             mesh: Optional[DataMesh] = None):
    """(state, batch, draws=None, generator=None) -> (state, metrics).

    joint_grad=True differentiates ONE scalar (detection total + tracking
    loss) over both models in a single backward, instead of the
    reference's two backward calls (`train_combined.py:546-553`).  With
    detached pose the two forms give the same updates; with
    `pose.differentiable=True` the joint form carries the tracking loss
    into the detector.  joint_grad=False keeps the reference's two
    backwards (`backward(inputs=...)`: the detection total into the
    detector, the tracking loss into the tracker).  accum_windows runs
    the batch window by window (one window's activations at a time) with
    one update; remat recomputes each window's forward in the backward
    (`torch.utils.checkpoint`) instead of keeping its activations.

    The returned step's `window_grad_fn(window, draws)` is the gradient of
    one window's loss, without touching `.grad`: ((loss, (detection total,
    tracking loss, loss dict)), (detector grads, tracker grads)), the
    grads as name -> tensor dicts; its `window_forward(window, draws)` is
    one window's (loss dict, tracking loss) with autograd, for gradients of
    a single term.  `device=None` means the GPU.  With a `mesh` the batch
    (and `draws`, when given) are this rank's rows of the global batch and
    the step is data-parallel (module docstring)."""
    if accum_windows and not joint_grad:
        raise ValueError(
            "accum_windows=True requires joint_grad=True: gradient "
            "accumulation is only implemented for the joint single-backward "
            "step")
    _check_trainable(cfg)
    dev = mesh_device(device, mesh)
    det_model.to(dev)
    trk_model.to(dev)
    dtype = next(det_model.parameters()).dtype
    cam = cfg.camera
    intrinsics = make_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy, dev).to(
        dtype)
    det_params = [p for _, p in det_model.named_parameters()]
    trk_params = [p for _, p in trk_model.named_parameters()]

    def window_forward(win: CombinedBatch, draws: WindowDraws):
        """One window (no B axis) -> (detection loss dict, tracking loss)."""
        gt = GroundTruth(boxes=win.gt_boxes2d, classes=win.gt_classes,
                         valid=win.gt_valid, masks=win.gt_masks,
                         voxels=win.gt_voxels, nocs=win.gt_nocs)
        feats = det_model.features(win.images)
        det_losses = det_model.train_losses(win.images, gt,
                                            draws.detection, feats)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and cfg.pose.differentiable):
            dets = det_model.predict_features(feats)
        frames = postprocess_frames(
            dets.boxes, dets.scores, dets.classes, dets.valid, dets.masks,
            dets.voxels, dets.nocs, win.gt_boxes2d, win.gt_valid, win.depth,
            win.campose, intrinsics, win.gt_boxes3d, cfg, True,
            draws.ransac)
        graph = build_graph(template, cfg.tracking, frames.valid,
                            frames.translations, frames.rotations,
                            frames.scales, frames.pred_boxes,
                            win.gt_boxes3d, win.gt_ids, win.gt_valid)
        vox = frames.voxels.reshape(-1, 32, 32, 32)
        logits = trk_model(vox, graph.src, graph.dst, graph.edge_attr,
                           graph.edge_mask)
        trk_loss = tracker_loss(logits, graph.targets, graph.edge_mask)
        # The empty graph (reference -inf sentinels, mpn_trainer.py:565-571):
        # no valid edge -> zero loss.
        trk_loss = torch.where(graph.edge_mask.any(), trk_loss,
                               torch.zeros_like(trk_loss))
        return det_losses, trk_loss

    def forward(win, draws):
        if remat:
            # The window draws nothing itself (its randomness is `draws`),
            # so the recomputation needs no RNG state.
            return checkpoint(window_forward, win, draws,
                              use_reentrant=False, preserve_rng_state=False)
        return window_forward(win, draws)

    def window_loss(win, draws):
        det_losses, tl = forward(win, draws)
        total = sum(v for k, v in det_losses.items() if k.startswith("loss"))
        return total + tl, (total, tl, det_losses)

    def _prepare(state, batch, draws, generator):
        batch = _widen(batch, dtype, dev)
        b, t = batch.images.shape[:2]
        if draws is None:
            size = 1 if mesh is None else mesh.size
            draws = make_window_draws(det_model, cfg, b * size, t, generator)
            if mesh is not None:
                draws = shard_batch(mesh, draws)
        draws = _draws_to(draws, dev)
        windows = [(CombinedBatch(*(x[i] for x in batch)),
                    _window_draws(draws, i)) for i in range(b)]
        state.det_opt.zero_grad(set_to_none=True)
        state.trk_opt.zero_grad(set_to_none=True)
        return windows

    def _finish(state, auxes):
        det_total = torch.stack([a[0] for a in auxes]).mean().detach()
        trk_total = torch.stack([a[1] for a in auxes]).mean().detach()
        metrics = {k: torch.stack([a[2][k] for a in auxes]).mean().detach()
                   for k in auxes[0][2]}
        metrics["tracking_loss"] = trk_total
        metrics["detection_total"] = det_total
        _reduce_grads(mesh, state.det_model, state.trk_model)
        update(state.det_model, state.det_opt, state.det_sched)
        update(state.trk_model, state.trk_opt, state.trk_sched)
        state.step += 1
        return state, metrics if mesh is None else all_mean(mesh, metrics)

    def joint_step(state: CombinedTrainState, batch: CombinedBatch,
                   draws: Optional[WindowDraws] = None,
                   generator: Optional[torch.Generator] = None):
        windows = _prepare(state, batch, draws, generator)
        b = len(windows)
        auxes = []
        if accum_windows and b > 1:
            # One window in flight at a time, gradients summed in .grad.
            for win, d in windows:
                loss, aux = window_loss(win, d)
                (loss / b).backward()
                auxes.append(aux)
        else:
            losses = []
            for win, d in windows:
                loss, aux = window_loss(win, d)
                losses.append(loss)
                auxes.append(aux)
            torch.stack(losses).mean().backward()
        return _finish(state, auxes)

    def two_backward_step(state: CombinedTrainState, batch: CombinedBatch,
                          draws: Optional[WindowDraws] = None,
                          generator: Optional[torch.Generator] = None):
        windows = _prepare(state, batch, draws, generator)
        auxes = [window_loss(win, d)[1] for win, d in windows]
        det_total = torch.stack([a[0] for a in auxes]).mean()
        trk_total = torch.stack([a[1] for a in auxes]).mean()
        det_total.backward(inputs=det_params, retain_graph=True)
        trk_total.backward(inputs=trk_params)
        return _finish(state, auxes)

    def _one(win: CombinedBatch):
        """One window (no B axis) moved to the device and widened."""
        one = _widen(CombinedBatch(*(torch.as_tensor(x)[None] for x in win)),
                     dtype, dev)
        return CombinedBatch(*(x[0] for x in one))

    def window_grad_fn(win: CombinedBatch, draws: WindowDraws):
        loss, aux = window_loss(_one(win), _draws_to(draws, dev))
        grads = torch.autograd.grad(loss, det_params + trk_params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(det_params + trk_params, grads)]
        names_d = [n for n, _ in det_model.named_parameters()]
        names_t = [n for n, _ in trk_model.named_parameters()]
        det_g = dict(zip(names_d, grads[:len(names_d)]))
        trk_g = dict(zip(names_t, grads[len(names_d):]))
        return (loss.detach(), _detach(aux)), (det_g, trk_g)

    out = joint_step if joint_grad else two_backward_step
    out.window_grad_fn = window_grad_fn
    out.window_forward = lambda win, draws: forward(_one(win),
                                                    _draws_to(draws, dev))
    return out


def _detach(aux):
    total, tl, losses = aux
    return total.detach(), tl.detach(), {k: v.detach()
                                         for k, v in losses.items()}
