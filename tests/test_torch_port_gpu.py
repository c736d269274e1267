"""The port's CUDA kernels against their plain versions on the card.

Marked `gpu`: each test decides in its body whether there is a CUDA device
and skips without one.  On a machine with a card:

    python -m pytest tests/test_torch_port_gpu.py -q -m gpu

The kernels are built with -fmad=false and evaluate the plain versions'
expressions in the same order, so the comparisons are exact; the stated
tolerances (1e-5 mean-kNN, 2e-5 feats) are the contract of the JAX package's
kernel tests.  Exact NMS has no tolerance: kept masks are equal.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import knn_cases

pytestmark = pytest.mark.gpu
KNN_CASES = knn_cases()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _knn_check(k1, pts, valid, cols, k):
    """K1 against its plain version on every row (invalid rows are 0 in
    both), and the kept masks after the threshold."""
    from mot3d_tpu_torch.geometry.outlier import _threshold_keep

    before = k1.launches.count
    got = k1.knn_mean_dists(pts, valid, cols, k)
    want = k1.knn_mean_dists_plain(pts, valid, cols, k)
    assert k1.launches.count == before + 1
    assert float((got - want).abs().max()) <= 1e-5
    assert not got[~valid].any()
    for min_points in (1, 100):
        assert torch.equal(_threshold_keep(got, valid, 2.0, min_points),
                           _threshold_keep(want, valid, 2.0, min_points))


@pytest.mark.parametrize("candidates", [256, 0])
def test_knn_outlier_kernel_matches_plain(candidates):
    """The path's shapes: 1024 points, 256 candidates with k = 5 (subset
    mode) or all 1024 with k = 20 (full mode)."""
    from mot3d_tpu_torch.geometry.outlier import candidate_columns
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1

    dev = _cuda()
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(16, 1024, 3)).astype(np.float32) * 0.1
    pts[:, :30] *= 30
    valid = rng.uniform(size=(16, 1024)) > 0.2
    pts, valid = torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev)
    cols, k = candidate_columns(1024, candidates, 20, dev)
    valid[0, cols.long()] = False
    _knn_check(k1, pts, valid, cols, k)


@pytest.mark.parametrize("name", sorted(KNN_CASES))
def test_knn_outlier_kernel_matches_plain_on_case(name):
    """Every compiled top-k width, C = 1 and 2048, exact ties, and
    detections with no valid points, no valid candidates or fewer than k."""
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1

    dev = _cuda()
    pts, valid, cols, k = KNN_CASES[name]
    _knn_check(k1, *(torch.from_numpy(a).to(dev) for a in (pts, valid, cols)),
               k)


@pytest.mark.parametrize("p,grid", [(28, 32), (27, 33)])
def test_pose_extract_kernel_matches_plain(p, grid):
    """The path's shapes (bulk-copy staging), and odd P with G = 33
    (per-thread staging, a ragged last round, unaligned output rows)."""
    from mot3d_tpu_torch.ops.cuda import pose_extract as k2
    from mot3d_tpu_torch.pose.extraction import grid_extract

    dev = _cuda()
    rng = np.random.default_rng(1)
    s, f = 32, 4
    x0 = rng.uniform(-20, 300, s)
    y0 = rng.uniform(-20, 220, s)
    boxes = np.stack([x0, y0, x0 + rng.uniform(8, 160, s),
                      y0 + rng.uniform(8, 120, s)], 1)
    args = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.uniform(size=(s, p, p, 3)), rng.uniform(size=(s, p, p)),
        boxes, rng.uniform(0.5, 5, (f, 240, 320)))]
    intr = torch.tensor([[292.9, 0, 159.5], [0, 292.9, 119.5], [0, 0, 1]],
                        device=dev)
    before = k2.launches.count
    feats, valid = k2.pose_extract(*args, intr, grid)
    feats_w, valid_w = grid_extract(*args, intr, grid)
    assert k2.launches.count == before + 1
    assert torch.equal(valid, valid_w)
    assert float((feats - feats_w).abs().max()) <= 2e-5


def test_nms_kernel_matches_plain_on_every_case():
    """`nms_mask(exact=True)` on the card (sort, K3, unsort) against the
    sort-free fixpoint on the card, on the CPU test's cases."""
    from mot3d_tpu_torch.ops import nms as nms_ops
    from mot3d_tpu_torch.ops.cuda import nms as k3
    from torch_port_helpers import nms_cases

    dev = _cuda()
    for name, (boxes, scores, valid, thresh) in nms_cases().items():
        args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, valid)]
        before = k3.launches.count
        got = nms_ops.nms_mask(*args, thresh, exact=True)
        want = nms_ops.nms_mask_plain(*args, thresh, exact=True)
        assert k3.launches.count == before + 1, name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("q,k,thresh", [(25, 1000, 0.7), (175, 500, 0.4),
                                        (3, 1500, 0.7)])
def test_nms_sorted_kernel_matches_plain_at_path_shapes(q, k, thresh):
    """Score-sorted problems at the evaluation path's shapes, and one whose
    mask needs the global scratch buffer."""
    from mot3d_tpu_torch.ops.cuda import nms as k3

    dev = _cuda()
    rng = np.random.default_rng(2)
    ctr = rng.uniform(0, 1, (q, k, 2)) * [320, 256]
    wh = rng.uniform(8, 200, (q, k, 2))
    boxes = np.clip(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1), 0,
                    [320, 256, 320, 256]).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(q, k)) < 0.9).to(dev)
    got = k3.nms_sorted(boxes, valid, thresh)
    assert torch.equal(got, k3.nms_sorted_plain(boxes, valid, thresh))
    with pytest.raises(TypeError):
        k3.nms_sorted(boxes.double(), valid, thresh)


def test_knn_outlier_kernel_matches_plain_at_training_shapes():
    """The combined step's K1 call: T * I = 2 x 16 = 32 rows of 1024
    points, 256 candidates, k = 5; bit for bit."""
    from mot3d_tpu_torch.geometry.outlier import candidate_columns
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1

    dev = _cuda()
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(32, 1024, 3)).astype(np.float32) * 0.1
    pts[:, :25] *= 30
    valid = np.arange(1024)[None] < rng.integers(200, 1025, (32, 1))
    pts, valid = torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev)
    cols, k = candidate_columns(1024, 256, 20, dev)
    assert k == 5
    got = k1.knn_mean_dists(pts, valid, cols, k)
    assert torch.equal(got, k1.knn_mean_dists_plain(pts, valid, cols, k))


def test_pose_extract_backward_raises_on_the_card():
    """K2 writes through raw pointers: its autograd function refuses a
    gradient instead of returning a silent zero."""
    from mot3d_tpu_torch.ops.cuda import pose_extract as k2

    dev = _cuda()
    rng = np.random.default_rng(4)
    nocs = torch.from_numpy(rng.uniform(size=(4, 28, 28, 3)).astype(
        np.float32)).to(dev).requires_grad_()
    masks = torch.from_numpy(rng.uniform(size=(4, 28, 28)).astype(
        np.float32)).to(dev)
    boxes = torch.tensor([[10.0, 20, 80, 90]] * 4, device=dev)
    depth = torch.from_numpy(rng.uniform(1, 3, (2, 120, 160)).astype(
        np.float32)).to(dev)
    intr = torch.tensor([[140.0, 0, 79.5], [0, 140.0, 59.5], [0, 0, 1]],
                        device=dev)
    before = k2.launches.count
    feats, _ = k2.pose_extract(nocs, masks, boxes, depth, intr, 16)
    assert k2.launches.count == before + 1 and feats.requires_grad
    with pytest.raises(RuntimeError, match="K2 backward"):
        feats.sum().backward()


def test_tiny_combined_step_on_the_card():
    """One combined train step at the tiny configuration on the card, gates
    open: finite losses, K1 launched 4 times (twice in the window forward,
    twice in its recomputation), both models updated."""
    import dataclasses

    from __graft_entry__ import _tiny_config
    from mot3d_tpu_torch.data.samples import DetectionSample
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1
    from mot3d_tpu_torch.train.combined_trainer import CombinedTrainer
    from torch_port_helpers import port_config

    dev = _cuda()
    cfg = _tiny_config()
    cfg = port_config(cfg.replace(
        combined=dataclasses.replace(cfg.combined, objectness_thres=-1.0,
                                     iou2d_thres=-1.0),
        pose=dataclasses.replace(cfg.pose, min_inlier_ratio=0.0),
        tracking=dataclasses.replace(cfg.tracking, box_iou_thres=0.0)))
    det = cfg.detection
    m, h = det.max_instances, det.pad_height
    rng = np.random.default_rng(5)
    frames = []
    for f in range(2):
        boxes = np.float32([[5, 5, 25, 30], [30, 10, 55, 35],
                            [10, 35, 40, 60]])
        masks = np.zeros((m, h, h), np.float32)
        for j, (x0, y0, x1, y1) in enumerate(boxes.astype(int)):
            masks[j, y0:y1, x0:x1] = 1.0
        frames.append(DetectionSample(
            image=rng.uniform(0, 255, (h, h, 3)).astype(np.float32),
            depth=rng.uniform(1, 3, (h, h)).astype(np.float32),
            campose=np.eye(4, dtype=np.float32), boxes=boxes,
            classes=np.zeros(m, np.int32), valid=np.ones(m, bool),
            masks=masks, voxels=(rng.uniform(size=(m, 32, 32, 32)) < 0.3
                                 ).astype(np.float32),
            nocs=rng.uniform(size=(m, 28, 28, 3)).astype(np.float32),
            boxes3d=rng.normal(size=(m, 8, 3)).astype(np.float32),
            object_ids=np.roll(np.arange(m, dtype=np.int32), f),
            locations=np.zeros((m, 3), np.float32),
            rotations=np.zeros((m, 3), np.float32),
            scales3d=np.ones(m, np.float32)))
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        tr = CombinedTrainer(cfg, out)
        with torch.no_grad():
            tr.det_model.mask_head.Conv_4.bias.fill_(3.0)
        before = [p.detach().clone() for p in (
            tr.det_model.box_head.cls.weight,
            tr.trk_model.edge_classifier.Dense_1.weight)]
        k1.launches.reset()
        metrics = tr.train(iter([frames]), max_iter=1)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert k1.launches.count == 4
    assert not torch.equal(before[0], tr.det_model.box_head.cls.weight)
    assert not torch.equal(before[1],
                           tr.trk_model.edge_classifier.Dense_1.weight)
