"""Sequence inference, the serving path (counterpart of
`mot3d_tpu/parallel/infer_step.py`), on one GPU.

detect -> pose -> graph -> MPN for each padded 25-frame sequence of a
batch: `MaskRCNN.predict` over the T frames, `postprocess_frames` over all
T * I detection slots at once (so the K1 outlier kernel runs twice and the
K2 extraction kernel once per sequence, each as one large launch; with
`detection.fast_nms=False` the K3 exact-NMS kernel runs six times, once per
RPN level over all frames and once for the class-wise test NMS),
`build_graph`, and `TrackerModel`'s edge probabilities.  The B sequences of
a batch run one after another.  Host-side trajectory assembly and MOTA
(`tracking/tracker.py`, `tracking/mot_metrics.py`) consume the outputs
after `outputs_to_host` has brought them over in one copy.

Reference anchors: the eval path of `Detection/train_combined.py:128-433`
and tracking inference (`Tracking/inference.py:19-21`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import Config
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.geometry.backproject import make_intrinsics
from mot3d_tpu_torch.geometry.umeyama import make_draws
from mot3d_tpu_torch.models.mask_rcnn import Detections, MaskRCNN
from mot3d_tpu_torch.models.mpn import TrackerModel
from mot3d_tpu_torch.pose.pipeline import FrameDetections, postprocess_frames
from mot3d_tpu_torch.tracking.graph_builder import GraphTemplate, build_graph


class SequenceBatch(NamedTuple):
    """A batch of padded sequences (leading axis B).  The GT fields serve the
    evaluation protocol (2D-IoU gate, depth cleaning, graph identity);
    zero them for serving without GT.  Arrays or tensors on any device."""

    images: object              # (B, T, H, W, 3) pixels
    depth: object               # (B, T, H, W)
    campose: object             # (B, T, 4, 4)
    gt_boxes2d: object          # (B, T, M, 4)
    gt_valid2d: object          # (B, T, M) bool
    gt_boxes3d: object          # (B, T, M, 8, 3) world corners
    gt_boxes3d_cropped: object  # (B, T, M, 8, 3) depth-cropped GT boxes
    gt_ids: object              # (B, T, M) int
    gt_valid: object            # (B, T, M) bool


class SequenceOutputs(NamedTuple):
    """Everything host-side assembly + MOTA need."""

    edge_probs: torch.Tensor    # (B, E) forward-half edge sigmoids
    obj_ids: torch.Tensor       # (B, T, I) GT identity per detection
    valid: torch.Tensor         # (B, T, I)
    translations: torch.Tensor  # (B, T, I, 3)
    classes: torch.Tensor       # (B, T, I)
    scores: torch.Tensor        # (B, T, I) detector objectness


def outputs_to_host(outputs: SequenceOutputs) -> SequenceOutputs:
    """The same fields as numpy arrays, through one device-to-host copy: the
    fields are packed into one float64 buffer on the device (exact for the
    floats, flags and small integers they hold) and split on the host."""
    sizes = [x.numel() for x in outputs]
    flat = torch.cat([x.reshape(-1).double() for x in outputs]).cpu().numpy()
    return SequenceOutputs(*(
        part.reshape(tuple(x.shape)).astype(
            torch.empty(0, dtype=x.dtype).numpy().dtype)
        for part, x in zip(np.split(flat, np.cumsum(sizes)[:-1]), outputs)))


class SequenceInferStep:
    """The inference step; call it on a `SequenceBatch`.  Its stages
    (`detect`, `pose`, `track`) are public so a caller can time them."""

    def __init__(self, det_model: MaskRCNN, trk_model: TrackerModel,
                 template: GraphTemplate, cfg: Config, use_gt_gate: bool,
                 device: torch.device):
        self.det_model = det_model.to(device).eval()
        self.trk_model = trk_model.to(device).eval()
        self.template = template
        self.cfg = cfg
        self.use_gt_gate = use_gt_gate
        self.device = device
        cam = cfg.camera
        self.dtype = next(det_model.parameters()).dtype
        self.intrinsics = make_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy,
                                          device).to(self.dtype)
        self.e_fwd = len(template.src_frame)

    def _tensor(self, x, dtype):
        return torch.as_tensor(x, device=self.device).to(dtype)

    @torch.no_grad()
    def detect(self, images) -> Detections:
        """(T, H, W, 3) pixels -> padded detections (T, I, ...)."""
        return self.det_model.predict(self._tensor(images, self.dtype))

    @torch.no_grad()
    def pose(self, dets: Detections, seq: SequenceBatch,
             draws: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> FrameDetections:
        """One sequence's detections -> gated poses (T, I, ...).  `seq`
        holds that sequence's fields without the B axis; draws
        (T, I, iters, S) or None."""
        f = self.dtype
        return postprocess_frames(
            dets.boxes, dets.scores, dets.classes, dets.valid, dets.masks,
            dets.voxels, dets.nocs, self._tensor(seq.gt_boxes2d, f),
            self._tensor(seq.gt_valid2d, torch.bool),
            self._tensor(seq.depth, f), self._tensor(seq.campose, f),
            self.intrinsics, self._tensor(seq.gt_boxes3d_cropped, f),
            self.cfg, self.use_gt_gate,
            None if draws is None else self._tensor(draws, torch.int64),
            generator)

    @torch.no_grad()
    def track(self, frames: FrameDetections, seq: SequenceBatch):
        """Poses of one sequence -> (forward edge probabilities (E,),
        obj_ids (T, I))."""
        f = self.dtype
        graph = build_graph(self.template, self.cfg.tracking, frames.valid,
                            frames.translations, frames.rotations,
                            frames.scales, frames.pred_boxes,
                            self._tensor(seq.gt_boxes3d, f),
                            self._tensor(seq.gt_ids, torch.int32),
                            self._tensor(seq.gt_valid, torch.bool))
        vox = frames.voxels.reshape((-1,) + frames.voxels.shape[2:])
        logits = self.trk_model(vox, graph.src, graph.dst, graph.edge_attr,
                                graph.edge_mask)
        return torch.sigmoid(logits[-1])[:self.e_fwd], graph.obj_ids

    def __call__(self, batch: SequenceBatch,
                 draws: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> SequenceOutputs:
        """draws (B, T, I, iters, S) raw RANSAC draws, or None to make them
        with `generator` on the device."""
        outs = []
        p = self.cfg.pose
        for b in range(len(batch.images)):
            seq = SequenceBatch(*(x[b] for x in batch))
            dets = self.detect(seq.images)
            if draws is None:
                d = make_draws(tuple(dets.scores.shape) + (
                    p.ransac_iters, p.ransac_sample_size), generator,
                    self.device)
            else:
                d = draws[b]
            frames = self.pose(dets, seq, d)
            edge_probs, obj_ids = self.track(frames, seq)
            outs.append(SequenceOutputs(
                edge_probs=edge_probs, obj_ids=obj_ids, valid=frames.valid,
                translations=frames.translations, classes=frames.classes,
                scores=frames.objectness))
        return SequenceOutputs(*(torch.stack(x) for x in zip(*outs)))


def make_sequence_infer_step(det_model: MaskRCNN, trk_model: TrackerModel,
                             template: GraphTemplate, cfg: Config,
                             use_gt_gate: bool = True,
                             device=None) -> SequenceInferStep:
    """Build the batched inference step.  `device=None` means the GPU (and
    raises without one); the models are moved there."""
    return SequenceInferStep(det_model, trk_model, template, cfg,
                             use_gt_gate, resolve_device(device))
