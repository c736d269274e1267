"""Standalone tracking trainer (counterpart of
`mot3d_tpu/train/tracking_trainer.py`): the reference `Tracking/
mpn_trainer.py` Trainer (train / val / inference with MOTA) on padded
sequence dicts (`data/h5_io.py:pad_sequence` over the exporter's per-frame
.h5 files).

`TrackingTrainer(cfg, output_dir, device=None)` runs on the GPU unless the
caller passes `device="cpu"`.  The update is
`parallel/train_step.py:make_tracking_train_step` (AdamW at
`tracking.learning_rate`); the epoch order is a numpy permutation stream
seeded by `run.seed`, kept on resume.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import Config
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.export import to_host
from mot3d_tpu_torch.models.mpn import TrackerModel, tracker_loss
from mot3d_tpu_torch.parallel.train_step import (TrackingBatch,
                                                 TrackingTrainState,
                                                 make_tracking_train_step)
from mot3d_tpu_torch.tracking.graph_builder import build_graph, make_template
from mot3d_tpu_torch.tracking.mot_metrics import (accumulated_idf1,
                                                  accumulated_mota)
from mot3d_tpu_torch.tracking.tracker import Tracker
from mot3d_tpu_torch.tracking.visualise import export_sequence
from mot3d_tpu_torch.train.checkpoints import (CheckpointManager,
                                               resume_trainer)
from mot3d_tpu_torch.train.combined_trainer import adamw
from mot3d_tpu_torch.train.metrics_writer import MetricsWriter
from mot3d_tpu_torch.train.schedules import warmup_multistep


def sequences_to_batch(seqs: List[dict]) -> TrackingBatch:
    """Stack padded sequence dicts (the field names of `pad_sequence`)
    into a TrackingBatch of numpy arrays."""
    def f(k):
        return np.stack([np.asarray(s[k]) for s in seqs])

    return TrackingBatch(
        det_valid=f("det_valid"), translations=f("translations"),
        rotations=f("rotations"), scales=f("scales"),
        pred_boxes=f("pred_boxes"), voxels=f("voxels"),
        gt_boxes=f("gt_boxes"), gt_ids=f("gt_ids"), gt_valid=f("gt_valid"))


def validate_sequences(tracker: Tracker, template, seqs: List[dict],
                       forward: Callable, classwise: bool = False,
                       export_dir: Optional[str] = None) -> Dict[str, float]:
    """The validation loop both tracking trainers share: `forward(seq)`
    gives the host (edge probabilities, obj_ids, loss) of one sequence;
    trajectories are assembled and scored on the host (accumulated MOTA and
    IDF1, per class with `classwise`), and with `export_dir` each
    sequence's visualisations go to seq_<i>/."""
    summaries, losses = [], []
    e = len(template.src_frame)
    per_class_acc: Dict[str, list] = {}
    for si, seq in enumerate(seqs):
        probs, obj_ids, loss = forward(seq)
        losses.append(float(loss))
        pred = tracker.assemble(
            template, probs[:e], obj_ids.astype(np.int64),
            np.asarray(seq["det_valid"]), np.asarray(seq["translations"]),
            np.asarray(seq["classes"]))
        gt = tracker.gt_trajectories(
            np.asarray(seq["gt_ids"]), np.asarray(seq["gt_valid"]),
            np.asarray(seq["gt_locations"]), np.asarray(seq["gt_classes"]))
        if export_dir is not None:
            export_sequence(os.path.join(export_dir, f"seq_{si:03d}"), pred,
                            gt_trajectories=gt)
        if classwise:
            summary, per_class = tracker.evaluate(pred, gt, True)
            for k, v in per_class.items():
                per_class_acc.setdefault(k, []).append(v)
        else:
            summary = tracker.evaluate(pred, gt)
        summaries.append(summary)
    out = {
        "val_loss": float(np.mean(losses)) if losses else 0.0,
        "mota": accumulated_mota(summaries),
        "idf1": accumulated_idf1(summaries),
        "precision": float(np.mean([s["precision"] for s in summaries])),
        "recall": float(np.mean([s["recall"] for s in summaries])),
        "switches": float(sum(s["num_switches"] for s in summaries)),
    }
    for k, v in per_class_acc.items():
        out[f"mota_{k}"] = accumulated_mota(v)
    return out


class TrackingTrainer:
    """Mirrors `Tracking/mpn_trainer.py:34-214` (model + Adam + epoch
    loop) and :216-351/:728-809 (inference/val with MOTA)."""

    def __init__(self, cfg: Config, output_dir: str = "out/tracking",
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.run.seed)
            self.model = TrackerModel(cfg.graph, device=self.device)
        t = cfg.tracking
        self.template = make_template(t.seq_len, t.max_instances_per_frame,
                                      t.max_frame_dist)
        self.tracker = Tracker(t)
        self.output_dir = output_dir
        self.writer = MetricsWriter(output_dir, cfg.run.log_every)
        self.ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"))
        self.state: Optional[TrackingTrainState] = None
        self._step_fn = None

    # ------------------------------------------------------------------
    def init_state(self, sample=None, params=None) -> TrackingTrainState:
        """Fresh AdamW at step 0; `params` an optional tracker state_dict.
        `sample` is accepted for the JAX trainer's signature."""
        if params is not None:
            self.model.load_state_dict(params)
        t = self.cfg.tracking
        opt, sched = adamw(self.model.parameters(),
                           warmup_multistep(t.learning_rate), t.weight_decay)
        self.state = TrackingTrainState(self.model, opt, sched, 0)
        return self.state

    def _step(self):
        if self._step_fn is None:
            self._step_fn = make_tracking_train_step(
                self.model, self.template, self.cfg, self.device)
        return self._step_fn

    # ------------------------------------------------------------------
    def train(self, train_seqs: List[dict], val_seqs: List[dict],
              num_epochs: Optional[int] = None,
              batch_size: Optional[int] = None,
              resume: bool = False) -> Dict[str, float]:
        """Epochs over `train_seqs` in batches, then `validate` on
        `val_seqs`, a best-by-MOTA and a latest checkpoint per epoch.
        Returns the last validation's metrics."""
        t = self.cfg.tracking
        num_epochs = num_epochs or t.num_epochs
        batch_size = batch_size or t.batch_size
        if self.state is None:
            self.init_state()
        start_epoch = 0
        if resume:
            step0 = resume_trainer(self)
            if step0 is not None:
                # Skip the epochs the restored step has completed; their
                # permutations are still drawn below.
                per_epoch = max(1, len(train_seqs) // max(1, batch_size))
                start_epoch = min(num_epochs, step0 // per_epoch)
        step_fn = self._step()
        rng = np.random.default_rng(self.cfg.run.seed)
        last: Dict[str, float] = {}
        for epoch in range(num_epochs):
            order = rng.permutation(len(train_seqs))
            if epoch < start_epoch:
                continue
            for i in range(0, len(order) - batch_size + 1, batch_size):
                batch = sequences_to_batch(
                    [train_seqs[j] for j in order[i:i + batch_size]])
                self.state, metrics = step_fn(self.state, batch)
                self.writer.write(self.state.step, metrics)
            val = self.validate(val_seqs)
            step = self.state.step
            self.writer.write(step, val, split="val", echo=True)
            self.ckpt.update_best("mota", val["mota"], step, self.state)
            self.ckpt.save(step, self.state)
            last = val
        self.writer.flush()
        return last

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _forward_sequence(self, seq: dict):
        """(graph, last-step edge probabilities, loss) of one sequence."""
        dev, dtype = self.device, next(self.model.parameters()).dtype

        def t(k, dt):
            return torch.as_tensor(np.asarray(seq[k])).to(dev).to(dt)

        graph = build_graph(self.template, self.cfg.tracking,
                            t("det_valid", torch.bool),
                            t("translations", dtype), t("rotations", dtype),
                            t("scales", dtype), t("pred_boxes", dtype),
                            t("gt_boxes", dtype), t("gt_ids", torch.int32),
                            t("gt_valid", torch.bool))
        vox = t("voxels", dtype)
        self.model.eval()
        logits = self.model(vox.reshape((-1,) + vox.shape[-3:]), graph.src,
                            graph.dst, graph.edge_attr, graph.edge_mask)
        loss = tracker_loss(logits, graph.targets, graph.edge_mask)
        return graph, torch.sigmoid(logits[-1]), loss

    def validate(self, seqs: List[dict], classwise: bool = False,
                 export_dir: Optional[str] = None) -> Dict[str, float]:
        """Per-sequence MOTA + mean loss (`mpn_trainer.py:728-809`), one
        device-to-host copy per sequence; `export_dir` writes each
        sequence's replay.html (predicted and GT tracks) and trajectory
        PLYs under seq_<i>/ (the reference's visualise_pred_sequence)."""
        def forward(seq):
            graph, probs, loss = self._forward_sequence(seq)
            return to_host([probs, graph.obj_ids, loss], torch.float64)

        return validate_sequences(self.tracker, self.template, seqs, forward,
                                  classwise, export_dir)

    def inference(self, seqs: List[dict], classwise: bool = True,
                  export_dir: Optional[str] = None) -> Dict[str, float]:
        """`Tracking/inference.py`: evaluate a trained model on test
        sequences and print accumulated and per-class MOTA; `export_dir`
        as in `validate` (the CLI's `infer-tracking --export-vis`)."""
        result = self.validate(seqs, classwise=classwise,
                               export_dir=export_dir)
        for k, v in sorted(result.items()):
            print(f"{k}: {v:.4f}")
        return result
