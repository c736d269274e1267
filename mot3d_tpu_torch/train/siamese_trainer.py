"""Siamese (non-graph) tracking trainer (counterpart of
`mot3d_tpu/train/siamese_trainer.py`).

The reference's second trainer (`Tracking/trainer.py:33-978`, the
`--use_graph=False` path): consecutive-frame instance pairs classified from
voxel appearance embeddings and a relative-pose embedding, with the paper's
ablations (`no_pose`, `no_geo`, `use_triplet`, `use_l1`;
`Tracking/options.py:36-83`) and the feature precompute
(`Tracking/trainer.py:216-449`).

The pairs are the padded graph template restricted to dt == 1 and directed
(no message passing, so no undirected duplication).  A step is one backward
over a batch of sequences and one AdamW update at `siamese.learning_rate`.
`precompute_features` runs the voxel encoder once per sequence and caches
the (N, D) embeddings in memory or as .npz files; training from the cache
updates only the edge encoder and the classifier (the encoder's gradient
is zero), the split the reference's hdf5 cache makes.
`SiameseTrainer(cfg, output_dir, device=None)` runs on the GPU unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import Config
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.export import to_host
from mot3d_tpu_torch.models.siamese import (SiameseTracker, mine_triplets,
                                            siamese_bce_loss,
                                            siamese_edge_features,
                                            siamese_l1_loss, triplet_loss)
from mot3d_tpu_torch.parallel.train_step import (ModelTrainState,
                                                 TrackingBatch, update)
from mot3d_tpu_torch.tracking.graph_builder import (GraphTemplate,
                                                    build_graph,
                                                    make_template)
from mot3d_tpu_torch.tracking.tracker import Tracker
from mot3d_tpu_torch.train.checkpoints import (CheckpointManager,
                                               resume_trainer)
from mot3d_tpu_torch.train.combined_trainer import adamw
from mot3d_tpu_torch.train.metrics_writer import MetricsWriter
from mot3d_tpu_torch.train.schedules import warmup_multistep
from mot3d_tpu_torch.train.tracking_trainer import (sequences_to_batch,
                                                    validate_sequences)


class SiameseTrainState(ModelTrainState):
    """The siamese tracker's train state: model, AdamW, LR scheduler,
    step."""


def _graph(template, trk_cfg, seq: TrackingBatch):
    return build_graph(template, trk_cfg, seq.det_valid, seq.translations,
                       seq.rotations, seq.scales, seq.pred_boxes,
                       seq.gt_boxes, seq.gt_ids, seq.gt_valid)


def siamese_loss(model: SiameseTracker, cfg: Config, graph, voxels,
                 features) -> torch.Tensor:
    """The loss of one sequence graph; `voxels` (N, 32, 32, 32), or None
    when training from precomputed `features` (N, D)."""
    s = cfg.siamese
    if s.no_geo:
        h = None
    elif features is not None:
        h = features
    else:
        h = model.encode(voxels)
    if s.use_triplet:
        # The triplet loss replaces the edge loss, as in the reference
        # (`Tracking/trainer.py:565-567`).
        anchor, pos, neg, valid = mine_triplets(
            h, graph.src, graph.dst, graph.targets, graph.edge_mask)
        return triplet_loss(anchor, pos, neg, valid, s.triplet_margin)
    logits = model.classify(h, graph.src, graph.dst,
                            siamese_edge_features(graph.edge_attr),
                            graph.edge_mask)
    if s.use_l1:
        return siamese_l1_loss(logits, graph.targets, graph.edge_mask)
    return siamese_bce_loss(logits, graph.targets, graph.edge_mask,
                            s.pos_weight_max, s.logit_clamp)


def make_siamese_train_step(model: SiameseTracker, template: GraphTemplate,
                            cfg: Config, trk_cfg, from_features: bool = False,
                            device=None):
    """(state, batch[, features]) -> (state, metrics): the mean loss over
    the batch's sequences, one backward, one update.  `trk_cfg` is the
    directed dt == 1 TrackingConfig of the pairs; with from_features=True
    the step takes (B, N, D) embeddings instead of encoding the voxels."""
    dev = resolve_device(device)
    model.to(dev)
    dtype = next(model.parameters()).dtype

    def seq_loss(seq: TrackingBatch, feats):
        vox = seq.voxels.reshape((-1,) + tuple(seq.voxels.shape[-3:]))
        return siamese_loss(model, cfg, _graph(template, trk_cfg, seq),
                            None if from_features else vox, feats)

    def step(state: SiameseTrainState, batch: TrackingBatch, features=None):
        batch = TrackingBatch(*(
            torch.as_tensor(x, device=dev).to(
                torch.bool if name in ("det_valid", "gt_valid") else
                torch.int32 if name == "gt_ids" else dtype)
            for name, x in zip(TrackingBatch._fields, batch)))
        if from_features:
            features = torch.as_tensor(features, device=dev).to(dtype)
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.stack([
            seq_loss(TrackingBatch(*(x[b] for x in batch)),
                     features[b] if from_features else None)
            for b in range(batch.det_valid.shape[0])]).mean()
        if loss.requires_grad:      # a triplet loss on cached features
            loss.backward()         # reaches no parameter: zero gradients
        update(state.model, state.optimizer, state.scheduler)
        state.step += 1
        return state, {"siamese_loss": loss.detach()}

    return step


class SiameseTrainer:
    """Mirrors the reference's `Tracking/trainer.py` Trainer: model + Adam
    + epoch loop (:197-214), precompute (:216-237), validation and
    inference with MOTA (:239-364, :725-805)."""

    def __init__(self, cfg: Config, output_dir: str = "out/siamese",
                 device=None):
        if cfg.siamese.no_pose and cfg.siamese.no_geo:
            raise ValueError("no_pose and no_geo cannot both be set "
                             "(classifier would have no input)")
        if cfg.siamese.use_triplet and cfg.siamese.no_geo:
            raise ValueError("use_triplet needs appearance embeddings "
                             "(no_geo drops them)")
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.run.seed)
            self.model = SiameseTracker(cfg.siamese, device=self.device)
        # Directed, consecutive frames only
        # (`Tracking/datasets/siamese_dataset.py:93` pairs t with t + 1).
        self.trk_cfg = dataclasses.replace(cfg.tracking, undirected=False,
                                           max_frame_dist=1)
        self.template = make_template(self.trk_cfg.seq_len,
                                      self.trk_cfg.max_instances_per_frame, 1)
        self.tracker = Tracker(self.trk_cfg)
        self.output_dir = output_dir
        self.writer = MetricsWriter(output_dir, cfg.run.log_every)
        self.ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"))
        self.state: Optional[SiameseTrainState] = None
        self._step_fn: Dict[bool, object] = {}

    @property
    def dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    # ------------------------------------------------------------------
    def init_state(self, sample=None, params=None) -> SiameseTrainState:
        """Fresh AdamW at step 0; `params` an optional state_dict.
        `sample` is accepted for the JAX trainer's signature."""
        if params is not None:
            self.model.load_state_dict(params)
        s = self.cfg.siamese
        opt, sched = adamw(self.model.parameters(),
                           warmup_multistep(s.learning_rate), s.weight_decay)
        self.state = SiameseTrainState(self.model, opt, sched, 0)
        return self.state

    def _step(self, from_features: bool):
        if from_features not in self._step_fn:
            self._step_fn[from_features] = make_siamese_train_step(
                self.model, self.template, self.cfg, self.trk_cfg,
                from_features, self.device)
        return self._step_fn[from_features]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def precompute_features(self, seqs: List[dict],
                            cache_dir: Optional[str] = None
                            ) -> List[np.ndarray]:
        """Voxel-encoder embeddings (N, D) per sequence, aligned with
        `seqs`; with `cache_dir` each is kept as feats_<i>.npz and read
        back from there when present (the reference's hdf5 cache,
        `Tracking/trainer.py:396-449`)."""
        if self.cfg.siamese.no_geo:
            raise ValueError("no_geo has no appearance features")
        if self.state is None:
            self.init_state()
        out = []
        for i, seq in enumerate(seqs):
            path = (os.path.join(cache_dir, f"feats_{i:05d}.npz")
                    if cache_dir else None)
            if path and os.path.exists(path):
                with np.load(path) as f:
                    out.append(f["appearance"])
                continue
            vox = torch.as_tensor(np.asarray(seq["voxels"]).reshape(
                -1, 32, 32, 32)).to(self.device, self.dtype)
            feats = self.model.encode(vox).cpu().numpy()
            if path:
                os.makedirs(cache_dir, exist_ok=True)
                np.savez_compressed(path, appearance=feats)
            out.append(feats)
        return out

    # ------------------------------------------------------------------
    def train(self, train_seqs: List[dict], val_seqs: List[dict],
              num_epochs: Optional[int] = None,
              batch_size: Optional[int] = None, precompute: bool = False,
              cache_dir: Optional[str] = None,
              resume: bool = False) -> Dict[str, float]:
        """Epochs over `train_seqs`, a validation, a best-by-MOTA and a
        latest checkpoint per epoch; returns the last validation."""
        s = self.cfg.siamese
        num_epochs = num_epochs or s.num_epochs
        # Fewer sequences than batch_size still train.
        batch_size = max(1, min(batch_size or s.batch_size, len(train_seqs)))
        if self.state is None:
            self.init_state()
        start_epoch = 0
        if resume:
            step0 = resume_trainer(self)
            if step0 is not None:
                per_epoch = max(1, len(train_seqs) // batch_size)
                start_epoch = min(num_epochs, step0 // per_epoch)
        from_features = bool(precompute and not s.no_geo)
        feats = (self.precompute_features(train_seqs, cache_dir)
                 if from_features else None)
        step_fn = self._step(from_features)
        rng = np.random.default_rng(self.cfg.run.seed)
        last: Dict[str, float] = {}
        for epoch in range(num_epochs):
            order = rng.permutation(len(train_seqs))
            if epoch < start_epoch:
                continue        # resumed past it; its order is still drawn
            for i in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                batch = sequences_to_batch([train_seqs[j] for j in idx])
                if from_features:
                    self.state, metrics = step_fn(
                        self.state, batch, np.stack([feats[j] for j in idx]))
                else:
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
        """(graph, pair probabilities, BCE loss) of one sequence."""
        batch = sequences_to_batch([seq])
        one = TrackingBatch(*(
            torch.as_tensor(x[0], device=self.device).to(
                torch.bool if name in ("det_valid", "gt_valid") else
                torch.int32 if name == "gt_ids" else self.dtype)
            for name, x in zip(TrackingBatch._fields, batch)))
        graph = _graph(self.template, self.trk_cfg, one)
        self.model.eval()
        logits, _ = self.model(one.voxels.reshape(-1, 32, 32, 32), graph.src,
                               graph.dst,
                               siamese_edge_features(graph.edge_attr),
                               graph.edge_mask)
        s = self.cfg.siamese
        loss = siamese_bce_loss(logits, graph.targets, graph.edge_mask,
                                s.pos_weight_max, s.logit_clamp)
        return graph, torch.sigmoid(logits), loss

    def validate(self, seqs: List[dict], classwise: bool = False,
                 export_dir: Optional[str] = None) -> Dict[str, float]:
        """Per-sequence MOTA and the mean BCE loss
        (`Tracking/trainer.py:725-805`), one device-to-host copy per
        sequence; `export_dir` writes each sequence's replay.html and
        trajectory PLYs under seq_<i>/."""
        def forward(seq):
            graph, probs, loss = self._forward_sequence(seq)
            return to_host([probs, graph.obj_ids, loss], torch.float64)

        return validate_sequences(self.tracker, self.template, seqs, forward,
                                  classwise, export_dir)

    def inference(self, seqs: List[dict], classwise: bool = True,
                  export_dir: Optional[str] = None) -> Dict[str, float]:
        """Evaluate a trained model on test sequences and print the
        accumulated and per-class MOTA."""
        result = self.validate(seqs, classwise=classwise,
                               export_dir=export_dir)
        for k, v in sorted(result.items()):
            print(f"{k}: {v:.4f}")
        return result
