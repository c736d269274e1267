"""The yardstick's arithmetic: the model's FLOPs per served sequence and
per training step, counted from the layer shapes of the configuration's
plain reference on the meta device (no data, no device), and the
operations and bytes the K1 and K3 kernels' work needs, from the shapes
and validity of their inputs.

The FLOP counts are frozen in each configuration's file (`flops`); a CPU
test recomputes them here.  A kernel's operations and bytes are counted
for the inputs it was given, since its work depends on the data."""

from __future__ import annotations

import torch

from benchmark.common import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, meta_models

# K1: d2 takes 8 fp32 operations (3 multiplies and 2 adds for p.q, the
# norms' sum and the clamp), keeping the k smallest about 2 more per pair
# on the min/max pipe: ~10 per valid point-candidate pair.
K1_OPS_PER_PAIR = 10
# K3: ~14 fp32 operations per pair of valid boxes (intersection, the two
# areas, union and the threshold test), each pair once.
K3_OPS_PER_PAIR = 14
# K3: per box 16 bytes of coordinates, a 4-byte score and a valid byte in,
# a keep byte out.
K3_BYTES_PER_BOX = 22


def _flop_count(fn) -> int:
    """Matmul and convolution FLOPs of fn() on meta tensors.  Exact NMS's
    fixpoint asks for values (`torch.equal`) and counts no FLOPs, so it
    keeps every valid box here."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.ops import nms
    saved = nms.fixpoint_keep
    nms.fixpoint_keep = lambda valid, suppress: valid
    try:
        with FlopCounterMode(display=False) as fc:
            fn()
    finally:
        nms.fixpoint_keep = saved
    return int(fc.get_total_flops())


def serve_flops(conf: dict) -> int:
    """FLOPs of one served sequence: the detector's predict over its T
    frames and the tracker over its graph (every node and edge slot, as
    the padded graph computes them)."""
    from benchmark.reference.tracking.graph_builder import make_template
    _, cfg, det, trk = meta_models(conf)
    d, t = cfg.detection, cfg.tracking.seq_len
    det.eval()
    trk.eval()
    images = torch.zeros((t, d.pad_height, d.pad_width, 3), device="meta")
    tmpl = make_template(t, d.detections_per_image,
                         cfg.tracking.max_frame_dist)
    e = 2 * len(tmpl.src_frame) if cfg.tracking.undirected else \
        len(tmpl.src_frame)
    n = t * d.detections_per_image
    src = torch.zeros(e, dtype=torch.int64, device="meta")
    attr = torch.zeros((e, cfg.graph.edge_in_dim), device="meta")
    mask = torch.ones(e, dtype=torch.bool, device="meta")
    vox = torch.zeros((n, 32, 32, 32), device="meta")

    def run():
        with torch.no_grad():
            det.predict(images)
            trk(vox, src, src, attr, mask)
    return _flop_count(run)


def train_flops(conf: dict, batch: int) -> int:
    """FLOPs of one detection training step on `batch` frames: the
    training forward and its backward."""
    refs, cfg, det, _ = meta_models(conf)
    d = cfg.detection
    m, h, w = d.max_instances, d.pad_height, d.pad_width
    z = dict(device="meta")
    gt = refs.detector.GroundTruth(
        torch.zeros((batch, m, 4), **z),
        torch.zeros((batch, m), dtype=torch.int64, **z),
        torch.ones((batch, m), dtype=torch.bool, **z),
        torch.zeros((batch, m, h, w), **z),
        torch.zeros((batch, m, 32, 32, 32), **z),
        torch.zeros((batch, m, 28, 28, 3), **z))
    draws = refs.detector.DetectionDraws(
        torch.zeros((batch, det.anchors.shape[0]), **z),
        torch.zeros((batch, det.num_proposals_train() + m), **z))
    images = torch.zeros((batch, h, w, 3), **z)
    det.train()

    def run():
        losses = det.train_losses(images, gt, draws)
        sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    return _flop_count(run)


def k1_work(valid: torch.Tensor, cols: torch.Tensor) -> tuple:
    """(operations, bytes) K1's work needs for one call: valid (B, N) bool
    points, cols (C,) candidate indices.  Pairs are valid points x valid
    candidates of their detection; bytes are the points (12 each), the
    valid flags, the candidate indices (4 each) and the output (4 per
    point), each once."""
    b, n = valid.shape
    colv = valid[:, cols.long()]
    pairs = int((valid.sum(1).double() * colv.sum(1).double()).sum())
    nbytes = b * n * 12 + b * n + cols.numel() * 4 + b * n * 4
    return K1_OPS_PER_PAIR * pairs, nbytes


def k3_work(valid: torch.Tensor) -> tuple:
    """(operations, bytes) K3's work needs for one call: valid (..., K)
    bool boxes, every leading index a problem; each pair of valid boxes of
    a problem is tested once."""
    nv = valid.reshape(-1, valid.shape[-1]).sum(-1).double()
    ops = K3_OPS_PER_PAIR * float((nv * (nv - 1) / 2).sum())
    return ops, K3_BYTES_PER_BOX * valid.numel()


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the fp32 rate or
    bytes at the HBM rate, whichever is longer."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
