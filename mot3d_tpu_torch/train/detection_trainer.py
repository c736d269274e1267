"""Detection-only trainer (counterpart of
`mot3d_tpu/train/detection_trainer.py`): the reference `Detection/
train_net.py` FrontTrainer (manual loop, periodic eval, periodic
checkpoint, best-by-val model).

`DetectionTrainer(cfg, output_dir, device=None)` runs on the GPU unless the
caller passes `device="cpu"`.  One step: `MaskRCNN.train_losses` -> the sum
of the `loss*` terms -> backward -> AdamW under the warmup multistep
schedule (`combined_trainer.detection_optimizer`).  Batches travel compact
(uint8 image, bool masks and voxels) through `data/prefetch.py` and widen
on the device.  The detection draws of step s come from a generator seeded
by (run.seed, s), so a resumed run draws what the uninterrupted run would
have.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import MOTFRONT_CLASSES, Config
from mot3d_tpu_torch.data.detection_loader import (DetectionSample,
                                                   compact_sample)
from mot3d_tpu_torch.data.prefetch import device_prefetch
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.export import DetectorExporter, to_host
from mot3d_tpu_torch.models.mask_rcnn import (DetectionDraws, Detections,
                                              GroundTruth, MaskRCNN)
from mot3d_tpu_torch.parallel.train_step import ModelTrainState, update
from mot3d_tpu_torch.pose.pipeline import paste_patch
from mot3d_tpu_torch.train.checkpoints import (CheckpointManager,
                                               resume_trainer)
from mot3d_tpu_torch.train.combined_trainer import detection_optimizer
from mot3d_tpu_torch.train.metrics_writer import MetricsWriter


class DetectionTrainState(ModelTrainState):
    """The detector's train state: model, AdamW, LR scheduler, step."""


def sample_to_gt(batch: DetectionSample, dtype: torch.dtype,
                 device) -> GroundTruth:
    """The GroundTruth of a (B, ...) batch on `device`, widened to `dtype`
    (masks and voxels may arrive as bools)."""
    def t(x, dt):
        return torch.as_tensor(x).to(device).to(dt)

    return GroundTruth(boxes=t(batch.boxes, dtype),
                       classes=t(batch.classes, torch.int64),
                       valid=t(batch.valid, torch.bool),
                       masks=t(batch.masks, dtype),
                       voxels=t(batch.voxels, dtype),
                       nocs=t(batch.nocs, dtype))


def _iter_samples(batch: DetectionSample):
    """Split a leading-axis-batched DetectionSample into per-frame
    samples."""
    for i in range(np.asarray(batch.image).shape[0]):
        yield DetectionSample(*(np.asarray(f)[i] for f in batch))


class DetectionTrainer:
    def __init__(self, cfg: Config, output_dir: str = "out/detection",
                 device=None):
        self.cfg = cfg
        self.output_dir = output_dir
        self.device = resolve_device(device)
        # Initial weights from cfg.run.seed, without touching the global RNG.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.run.seed)
            self.model = MaskRCNN(cfg.detection, device=self.device)
        self.writer = MetricsWriter(output_dir, cfg.run.log_every)
        self.ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"))
        self.state: Optional[DetectionTrainState] = None
        self._exporter: Optional[DetectorExporter] = None
        self._img_writer = None

    @property
    def dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    def init_state(self, batch: Optional[DetectionSample] = None,
                   params=None) -> DetectionTrainState:
        """Fresh AdamW at step 0.  `params`: an optional detector
        state_dict to start from (e.g. `importers/flax_params.py:
        mask_rcnn_state_dict` of pretrained weights); the reference trains
        from COCO model-zoo weights (`Detection/cfg_setup.py:21`).  `batch`
        is accepted for the JAX trainer's signature."""
        if params is not None:
            self.model.load_state_dict(params)
        opt, sched = detection_optimizer(self.cfg, self.model)
        self.state = DetectionTrainState(self.model, opt, sched, 0)
        return self.state

    def train_step(self, batch: DetectionSample,
                   draws: DetectionDraws) -> Dict[str, torch.Tensor]:
        """One update on a (B, ...) batch with the given sampler draws;
        returns the loss dict (device scalars) with "total"."""
        state = self.state
        images = torch.as_tensor(batch.image).to(self.device).to(self.dtype)
        gt = sample_to_gt(batch, self.dtype, self.device)
        self.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        losses = self.model.train_losses(images, gt, draws)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        total.backward()
        update(self.model, state.optimizer, state.scheduler)
        state.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total"] = total.detach()
        return out

    # ------------------------------------------------------------------
    def train(self, batches: Iterator[DetectionSample],
              val_batches=None, max_iter: Optional[int] = None,
              full_eval: bool = True, resume: bool = False,
              init_params=None) -> Dict[str, float]:
        """`full_eval` adds the voxnocs and COCO-AP evaluators to the
        periodic eval, as the reference's do_test does (`train_net.py:
        66-90`).  `resume` reloads the latest full train state (params,
        optimizer, schedule, step) from this trainer's checkpoint dir
        (`Detection/train_net.py:99-110`)."""
        cfg = self.cfg.combined
        max_iter = max_iter or cfg.max_iter
        generator = torch.Generator(device=self.device)
        metrics: Dict[str, torch.Tensor] = {}
        for batch in device_prefetch(map(compact_sample, batches),
                                     self.device):
            if self.state is None:
                self.init_state(batch, params=init_params)
                if resume:
                    resume_trainer(self)
            step = self.state.step
            if step >= max_iter:
                break
            generator.manual_seed((self.cfg.run.seed + 2) * 1_000_003 + step)
            metrics = self.train_step(
                batch, self.model.make_draws(batch.image.shape[0], generator))
            step = self.state.step
            self.writer.write(step, metrics)
            if val_batches is not None and step % cfg.eval_period == 0:
                val = self.evaluate(val_batches, voxnocs=full_eval,
                                    ap=full_eval)
                self.writer.write(step, val, split="val", echo=True)
                if full_eval:
                    # Voxel/NOCS renders (FrontEvaluator put_image) and
                    # per-class AP / pose-error charts (save_ap).
                    self.write_image_summaries(next(iter(val_batches)), step)
                    self.write_chart_summaries(val, step)
                self.ckpt.update_best("val_loss", val["val_total"], step,
                                      self.state, higher_is_better=False)
            if step % cfg.checkpoint_period == 0:
                self.ckpt.save(step, self.state)
        self.writer.flush()
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def evaluate(self, batches, voxnocs: bool = False,
                 ap: bool = False) -> Dict[str, float]:
        """Validation losses (the reference's val-loss eval,
        `EvaluatorUtils.py:234-249`); with `voxnocs`/`ap` also the
        FrontEvaluator voxel-IoU + pose-error metrics and COCO bbox+segm
        AP, from ONE prediction pass shared by both."""
        out = self._evaluate_losses(batches)
        if voxnocs or ap:
            shared = [(batch, self.predict(batch.image))
                      for batch in batches]
            if voxnocs:
                out.update(self.evaluate_voxnocs(batches, shared=shared))
            if ap:
                out.update(self.evaluate_ap(batches, segm=True,
                                            shared=shared))
        return out

    def eval_draws(self, index: int, batch_size: int) -> DetectionDraws:
        """The sampler draws of the index-th validation batch (the same in
        every evaluation)."""
        generator = torch.Generator(device=self.device).manual_seed(
            (self.cfg.run.seed + 1) * 1_000_003 + index)
        return self.model.make_draws(batch_size, generator)

    @torch.no_grad()
    def _evaluate_losses(self, batches) -> Dict[str, float]:
        acc: Dict[str, list] = {}
        for i, batch in enumerate(batches):
            images = torch.as_tensor(np.asarray(batch.image)).to(
                self.device).to(self.dtype)
            losses = self.model.train_losses(
                images, sample_to_gt(batch, self.dtype, self.device),
                self.eval_draws(i, images.shape[0]))
            names = list(losses)
            vals = to_host([losses[k] for k in names], torch.float64)
            for k, v in zip(names, vals):
                acc.setdefault(k, []).append(float(v))
        out = {f"val_{k}": float(np.mean(v)) for k, v in acc.items()}
        out["val_total"] = sum(v for k, v in out.items()
                               if k.startswith("val_loss"))
        return out

    @torch.no_grad()
    def predict(self, images) -> Detections:
        self.model.eval()
        return self.model.predict(torch.as_tensor(np.asarray(
            images)).to(self.device).to(self.dtype))

    def evaluate_ap(self, batches, segm: bool = False,
                    shared=None) -> Dict[str, float]:
        """COCO-protocol bbox (and optionally segm) AP over a validation
        split (`EvaluatorUtils.py:358-415`; the vendored COCOEvaluator
        reports both tasks, `Detection/evaluator/CocoEvaluator.py:32`).
        `shared`: an optional precomputed [(batch, dets)] prediction
        pass."""
        from mot3d_tpu_torch.evaluator.coco_eval import COCOEvaluator
        ev = COCOEvaluator(self.cfg.detection.num_classes)
        pairs = (shared if shared is not None
                 else ((b, self.predict(b.image)) for b in batches))
        for batch, dets in pairs:
            fields = [dets.boxes, dets.scores, dets.classes, dets.valid]
            if segm:
                fields.append(self._paste_masks(dets.masks, dets.boxes))
            host = to_host(fields, torch.float64)
            for i in range(np.asarray(batch.image).shape[0]):
                ev.add_image(
                    host[0][i], host[1][i], host[2][i].astype(np.int64),
                    host[3][i].astype(bool), batch.boxes[i],
                    batch.classes[i], batch.valid[i],
                    dt_masks=host[4][i] if segm else None,
                    gt_masks=batch.masks[i] if segm else None)
        return ev.summarize()

    def _paste_masks(self, masks28, boxes):
        """Paste (B, D, 28, 28) ROI mask probabilities into full-image
        binary masks (detectron2 paste_masks_in_image equivalent)."""
        hw = (self.cfg.detection.pad_height, self.cfg.detection.pad_width)
        return paste_patch(masks28[..., None], boxes, hw)[..., 0] >= 0.5

    def exporter(self) -> DetectorExporter:
        if self._exporter is None:
            self._exporter = DetectorExporter(self.cfg, self.model,
                                              self.device)
        return self._exporter

    def evaluate_voxnocs(self, batches, shared=None) -> Dict[str, float]:
        """FrontEvaluator-equivalent voxel/NOCS eval during training:
        per-class mean voxel IoU + median pose rotation/location errors
        (`Detection/evaluator/FrontEvaluator.py:243-550`), through the
        exporter (K1 twice per frame).  `shared`: an optional precomputed
        [(batch, dets)] prediction pass whose per-frame slices replace the
        detector."""
        self.model.eval()
        exporter = self.exporter()
        if shared is None:
            samples = (s for batch in batches for s in _iter_samples(batch))
            return exporter.evaluate_samples(samples)
        samples, dets_list = [], []
        for batch, dets in shared:
            for i, s in enumerate(_iter_samples(batch)):
                samples.append(s)
                dets_list.append(Detections(*(x[i:i + 1] for x in dets)))
        return exporter.evaluate_samples(samples, dets_list=dets_list)

    # ------------------------------------------------------------------
    def _writer(self):
        from mot3d_tpu_torch.train.image_summaries import ImageWriter
        if self._img_writer is None:
            self._img_writer = ImageWriter(self.output_dir)
        return self._img_writer

    def write_image_summaries(self, batch: DetectionSample, step: int,
                              max_instances: int = 3) -> list:
        """Voxel renders + NOCS patch panels for a few GT instances (the
        reference's tensorboard put_image calls during eval,
        `FrontEvaluator.py:293-333` and `:442-452`).  The heads run on the
        GT boxes (`predict_given_boxes`) so pred/GT pairs align.  Returns
        the PNG paths written."""
        from mot3d_tpu_torch.train.image_summaries import (
            render_nocs_panel, render_voxel_views)
        self.model.eval()
        t = lambda x, dt: torch.as_tensor(np.asarray(x)[:1]).to(  # noqa
            self.device).to(dt)
        _, pred_voxels, pred_nocs = self.model.predict_given_boxes(
            t(batch.image, self.dtype), t(batch.boxes, self.dtype),
            t(batch.classes, torch.int64))
        pred_voxels, pred_nocs = to_host([pred_voxels[0], pred_nocs[0]],
                                         torch.float32)
        valid = np.asarray(batch.valid)
        paths, written = [], 0
        for i in range(valid.shape[1]):
            if written >= max_instances or not valid[0, i]:
                continue
            vox_img = render_voxel_views(pred_voxels[i] >= 0.5,
                                         np.asarray(batch.voxels)[0, i]
                                         >= 0.5)
            paths.append(self._writer().write_image(
                step, f"voxels/inst{i}", vox_img))
            nocs_img = render_nocs_panel(pred_nocs[i],
                                         np.asarray(batch.nocs)[0, i])
            paths.append(self._writer().write_image(
                step, f"nocs/inst{i}", nocs_img))
            written += 1
        return paths

    def write_chart_summaries(self, metrics: Dict[str, float],
                              step: int) -> list:
        """Per-class bar charts from the eval metrics: bbox/segm AP per
        class (`EvaluatorUtils.py:358-415` save_ap) and voxel-IoU /
        rotation / location medians per class, then per-instance error
        histograms of the last voxnocs eval."""
        from mot3d_tpu_torch.train.image_summaries import (render_class_bars,
                                                           render_histogram)
        charts = []
        for task in ("bbox", "segm"):
            per_class = {
                MOTFRONT_CLASSES[int(k.rsplit("class_", 1)[1])]: v
                for k, v in metrics.items()
                if k.startswith(f"{task}/AP/class_")}
            if per_class:
                charts.append((f"ap/{task}", per_class,
                               f"{task} AP per class", "AP"))
        for metric, ylabel in (("voxel_iou", "IoU"),
                               ("rot_err_median", "deg"),
                               ("loc_err_median", "m")):
            per_class = {k.split("/")[0]: v for k, v in metrics.items()
                         if k.endswith("/" + metric)}
            if per_class:
                charts.append((f"pose/{metric}", per_class, metric, ylabel))
        paths = [self._writer().write_image(
            step, tag, render_class_bars(vals, title, ylabel))
            for tag, vals, title, ylabel in charts]
        raw = self._exporter.last_raw_metrics if self._exporter else None
        for metric, xlabel in (("rot_err", "deg"), ("loc_err", "m")):
            pooled = [v for per_cls in (raw or {}).values()
                      for v in per_cls.get(metric, [])]
            if pooled:
                paths.append(self._writer().write_image(
                    step, f"hist/{metric}",
                    render_histogram(pooled, f"{metric} per instance",
                                     xlabel)))
        return paths
