"""End-to-end trainer: detect -> reconstruct -> pose -> track (counterpart
of `mot3d_tpu/train/combined_trainer.py`).

The reference flagship `Detection/train_combined.py`:
  - do_train (:435-569): per iteration, detection losses + a second full
    eval forward, pose fitting, graph build, tracking BCE, two independent
    optimizer steps (`parallel/train_step.py:make_combined_train_step`);
  - do_test (:128-433): per test sequence, detector -> pose -> tracker ->
    trajectories -> MOTA (accumulated + classwise), keeping the best model
    by accumulated MOTA (check_save_models, :94-124).

`CombinedTrainer(cfg, output_dir, device=None)` runs on the GPU unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import Config
from mot3d_tpu_torch.data.samples import DetectionSample
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.geometry.umeyama import make_draws
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
from mot3d_tpu_torch.models.mpn import TrackerModel
from mot3d_tpu_torch.parallel.infer_step import (SequenceBatch,
                                                 make_sequence_infer_step)
from mot3d_tpu_torch.parallel.train_step import (CombinedBatch,
                                                 CombinedTrainState,
                                                 make_combined_train_step)
from mot3d_tpu_torch.pose.pipeline import FrameDetections
from mot3d_tpu_torch.tracking.graph_builder import make_template
from mot3d_tpu_torch.tracking.mot_metrics import (accumulated_idf1,
                                                  accumulated_mota)
from mot3d_tpu_torch.tracking.tracker import Tracker
from mot3d_tpu_torch.train.checkpoints import CheckpointManager
from mot3d_tpu_torch.train.metrics_writer import MetricsWriter
from mot3d_tpu_torch.train.schedules import warmup_multistep


def samples_to_combined_window(frames: List[DetectionSample]
                               ) -> CombinedBatch:
    """Stack T per-frame DetectionSamples into one window (no batch dim),
    as CPU tensors.  The heavy fields travel compact (uint8 image, bool
    masks and voxels: exactly representable values); the step widens them
    on the device."""
    def f(k, dt=None):
        a = np.stack([getattr(s, k) for s in frames])
        return torch.from_numpy(np.ascontiguousarray(
            a.astype(dt) if dt else a))

    return CombinedBatch(
        images=f("image", np.uint8), depth=f("depth"), campose=f("campose"),
        gt_boxes2d=f("boxes"), gt_classes=f("classes"), gt_valid=f("valid"),
        gt_masks=f("masks", bool), gt_voxels=f("voxels", bool),
        gt_nocs=f("nocs"), gt_boxes3d=f("boxes3d"), gt_ids=f("object_ids"))


def adamw(params, schedule: Callable[[int], float], weight_decay: float):
    """`optax.adamw(schedule, weight_decay=...)` as `torch.optim.AdamW` and a
    `LambdaLR` over it.

    optax applies  p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p),
    with m_hat, v_hat the bias-corrected moments and lr_t = schedule(t), t
    the count of updates already made.  torch's AdamW first decays
    p <- p * (1 - lr * wd) and then subtracts lr * m_hat / (sqrt(v_hat) +
    eps): the Adam term does not depend on p, so the two orders give the
    same update.  Both decay every parameter, biases and norm scales
    included, with b1 0.9, b2 0.999, eps 1e-8.  The optimizer's base LR is
    1 and the schedule is the `LambdaLR` factor, so the group's LR is
    schedule(t) itself: `LambdaLR` evaluates it at 0 when it is built and
    at t after the t-th `scheduler.step()`."""
    opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def detection_optimizer(cfg: Config, model: MaskRCNN):
    """The detector's AdamW under WarmupMultiStepLR
    (`Detection/cfg_setup.py:109-114`)."""
    c = cfg.combined
    return adamw(model.parameters(),
                 warmup_multistep(c.detection_lr, c.lr_warmup_iters,
                                  c.lr_warmup_factor, c.lr_steps,
                                  c.lr_gamma),
                 c.detection_weight_decay)


def tracking_optimizer(cfg: Config, model: TrackerModel):
    """The tracker's AdamW at a constant LR."""
    c = cfg.combined
    return adamw(model.parameters(), warmup_multistep(c.tracking_lr),
                 c.tracking_weight_decay)


def _pad_frames(x: torch.Tensor, t: int) -> torch.Tensor:
    pad = x.new_zeros((t - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad])


class CombinedTrainer:
    def __init__(self, cfg: Config, output_dir: str = "out/combined",
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # The models' initial weights come from cfg.run.seed, without
        # touching the global RNG.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.run.seed)
            self.det_model = MaskRCNN(cfg.detection, device=self.device)
            self.trk_model = TrackerModel(cfg.graph, device=self.device)
        self.window_template = make_template(
            cfg.combined.batch_size, cfg.detection.detections_per_image,
            cfg.tracking.max_frame_dist)
        self.seq_template = make_template(
            cfg.tracking.seq_len, cfg.detection.detections_per_image,
            cfg.tracking.max_frame_dist)
        self.tracker = Tracker(cfg.tracking)
        self.writer = MetricsWriter(output_dir, cfg.run.log_every)
        self.ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"))
        self.state: Optional[CombinedTrainState] = None
        self._step_fn = None
        self._infer = None

    # ------------------------------------------------------------------
    def init_state(self, window: Optional[CombinedBatch] = None,
                   det_params=None) -> CombinedTrainState:
        """Fresh optimizers at step 0.  `det_params`: an optional detector
        state_dict to start from — the reference's combined training starts
        from a TRAINED detector (`cfg.MODEL.WEIGHTS = .../best_model.pth`,
        `Detection/cfg_setup.py:137`).  `window` is accepted for the JAX
        trainer's signature; torch modules need no example input."""
        if det_params is not None:
            self.det_model.load_state_dict(det_params)
        det_opt, det_sched = detection_optimizer(self.cfg, self.det_model)
        trk_opt, trk_sched = tracking_optimizer(self.cfg, self.trk_model)
        self.state = CombinedTrainState(self.det_model, det_opt, det_sched,
                                        self.trk_model, trk_opt, trk_sched,
                                        0)
        return self.state

    # ------------------------------------------------------------------
    def train(self, windows: Iterator[List[DetectionSample]],
              max_iter: Optional[int] = None,
              test_seqs: Optional[List[List[DetectionSample]]] = None,
              resume: bool = False, det_init_params=None
              ) -> Dict[str, float]:
        """windows: iterator of T-frame windows (T = combined.batch_size,
        consecutive frames of one sequence, as the reference's non-shuffled
        2-frame batches, `train_combined.py:88,481`).  `resume` reloads the
        latest full train state; `det_init_params` warm-starts the
        detector.  Returns the last step's metrics.  Each step's random
        draws come from a generator seeded by (run.seed, step), so a
        resumed run draws what the uninterrupted run would have."""
        cfg = self.cfg.combined
        max_iter = max_iter or cfg.max_iter
        generator = torch.Generator(device=self.device)
        metrics: Dict[str, torch.Tensor] = {}
        for frames in windows:
            window = samples_to_combined_window(frames)
            batch = CombinedBatch(*(x[None] for x in window))
            if self.state is None:
                self.init_state(window, det_params=det_init_params)
                if resume:
                    from mot3d_tpu_torch.train.checkpoints import \
                        resume_trainer
                    resume_trainer(self)
            step = self.state.step
            if step >= max_iter:
                break
            if self._step_fn is None:
                self._step_fn = make_combined_train_step(
                    self.det_model, self.trk_model, self.window_template,
                    self.cfg, joint_grad=cfg.joint_grad,
                    accum_windows=cfg.accum_windows, device=self.device)
            self.det_model.train()
            self.trk_model.train()
            generator.manual_seed((self.cfg.run.seed + 3) * 1_000_003 + step)
            self.state, metrics = self._step_fn(self.state, batch,
                                                generator=generator)
            step = self.state.step
            self.writer.write(step, metrics)
            if test_seqs is not None and step % cfg.eval_period == 0:
                mota = self.do_test(test_seqs)
                if self.ckpt.update_best("mota", mota["mota"], step,
                                         self.state):
                    print(f"new best MOTA {mota['mota']:.4f} at step {step}")
            if step % cfg.checkpoint_period == 0:
                self.ckpt.save(step, self.state)
        self.writer.flush()
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def do_test(self, sequences: List[List[DetectionSample]],
                classwise: bool = True) -> Dict[str, float]:
        """Full eval: detector -> pose -> tracker -> accumulated MOTA
        (`train_combined.py:128-433`), each sequence cut or padded to
        tracking.seq_len frames."""
        if self._infer is None:
            self._infer = make_sequence_infer_step(
                self.det_model, self.trk_model, self.seq_template, self.cfg,
                device=self.device)
        step = self._infer
        t_len = self.cfg.tracking.seq_len
        p = self.cfg.pose
        generator = torch.Generator(device=self.device).manual_seed(7)
        summaries, per_class_acc = [], {}
        for frames in sequences:
            frames = frames[:t_len]
            n = len(frames)
            win = samples_to_combined_window(frames)
            seq = SequenceBatch(
                images=win.images, depth=win.depth, campose=win.campose,
                gt_boxes2d=win.gt_boxes2d, gt_valid2d=win.gt_valid,
                gt_boxes3d=win.gt_boxes3d, gt_boxes3d_cropped=win.gt_boxes3d,
                gt_ids=win.gt_ids, gt_valid=win.gt_valid)
            dets = step.detect(seq.images)
            draws = make_draws((n,) + tuple(dets.scores.shape[1:])
                               + (p.ransac_iters, p.ransac_sample_size),
                               generator, self.device)
            out = step.pose(dets, seq, draws)
            padded = FrameDetections(*(_pad_frames(x, t_len) for x in out))
            seq_p = SequenceBatch(*(_pad_frames(torch.as_tensor(x), t_len)
                                    for x in seq))
            probs, obj_ids = step.track(padded, seq_p)
            pred = self.tracker.assemble(
                self.seq_template, probs.cpu().numpy(),
                obj_ids.cpu().numpy(), padded.valid.cpu().numpy(),
                padded.translations.cpu().numpy(),
                padded.classes.cpu().numpy())
            gt = self.tracker.gt_trajectories(
                seq_p.gt_ids.numpy(), seq_p.gt_valid.numpy(),
                np.pad(np.stack([f.locations for f in frames]),
                       ((0, t_len - n), (0, 0), (0, 0))),
                np.pad(np.stack([f.classes for f in frames]),
                       ((0, t_len - n), (0, 0))))
            if classwise:
                summary, per_class = self.tracker.evaluate(pred, gt, True)
                for k, v in per_class.items():
                    per_class_acc.setdefault(k, []).append(v)
            else:
                summary = self.tracker.evaluate(pred, gt)
            summaries.append(summary)
        out = {
            "mota": accumulated_mota(summaries),
            "idf1": accumulated_idf1(summaries),
            "precision": float(np.mean([s["precision"] for s in summaries])),
            "recall": float(np.mean([s["recall"] for s in summaries])),
        }
        for k, v in per_class_acc.items():
            out[f"mota_{k}"] = accumulated_mota(v)
        self.writer.write(self.state.step if self.state else 0, out,
                          split="test", echo=True)
        return out
