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
    """`nms_mask(exact=True)` on the card (K3: one launch, sort inside)
    against the sort-free fixpoint on the card, on the CPU test's cases
    (the class-wise case as a `movedim` view)."""
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


@pytest.mark.parametrize("q,k,thresh", [(25, 1000, 0.7), (25, 960, 0.7),
                                        (25, 240, 0.7), (25, 60, 0.7),
                                        (175, 500, 0.4), (2, 2000, 0.7),
                                        (1, 4096, 0.7)])
def test_nms_sorted_kernel_matches_plain_at_path_shapes(q, k, thresh):
    """Unsorted problems at the evaluation path's shapes, the training
    path's (2, 2000) and the largest K, whose mask fills a cluster of 8."""
    from mot3d_tpu_torch.ops import nms as nms_ops
    from mot3d_tpu_torch.ops.cuda import nms as k3

    dev = _cuda()
    rng = np.random.default_rng(2)
    ctr = rng.uniform(0, 1, (q, k, 2)) * [320, 256]
    wh = rng.uniform(8, 200, (q, k, 2))
    boxes = np.clip(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1), 0,
                    [320, 256, 320, 256]).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(dev)
    scores = torch.from_numpy(
        rng.uniform(size=(q, k)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(q, k)) < 0.9).to(dev)
    got = k3.exact_nms_mask(boxes, scores, valid, thresh)
    assert torch.equal(got, nms_ops.nms_mask_plain(boxes, scores, valid,
                                                   thresh))
    assert 1 <= k3.last_cluster <= 8
    with pytest.raises(TypeError):
        k3.exact_nms_mask(boxes.double(), scores, valid, thresh)


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


def test_oracle_export_frame_on_the_card_matches_the_cpu():
    """One fixture frame through `DetectorExporter.export_frame` in oracle
    mode on the card and on the CPU with the same draws, in both extraction
    modes: the same kept slots and classes, poses within 1e-3 (float32
    fits: the card sums in another order), K1 twice per frame and K2 once
    with pose.extraction='pallas' (0 times at 'grid')."""
    import dataclasses

    from __graft_entry__ import _tiny_config
    from mot3d_tpu_torch.data.fixtures import (fixture_samples,
                                               render_motfront_scenes)
    from mot3d_tpu_torch.export import DetectorExporter
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1
    from mot3d_tpu_torch.ops.cuda import pose_extract as k2
    from torch_port_helpers import port_config

    dev = _cuda()
    cfg = port_config(_tiny_config())
    (sample,), = fixture_samples(render_motfront_scenes(
        1, 1, 3, 1, cfg.camera, camera_dist=2.6, half_range=(0.35, 0.6)),
        cfg.detection)
    draws = torch.randint(0, 2**31 - 1, (cfg.detection.max_instances,
                                         cfg.pose.ransac_iters,
                                         cfg.pose.ransac_sample_size),
                          generator=torch.Generator().manual_seed(0))
    for mode in ("grid", "pallas"):
        c = cfg.replace(pose=dataclasses.replace(cfg.pose, extraction=mode))
        frames = {}
        for d in ("cpu", dev):
            ex = DetectorExporter(c, MaskRCNN(c.detection, device=d), d)
            k1.launches.reset()
            k2.launches.reset()
            m = ex.export_frame(sample, None, draws, oracle=True)
            frames[str(d)] = (m, ex.last_frame,
                              k1.launches.count, k2.launches.count)
        (m_c, f_c, _, _), (m_g, f_g, n1, n2) = frames["cpu"], frames["cuda"]
        assert m_g["classes"] == m_c["classes"] and len(m_g["classes"]) >= 2
        assert (n1, n2) == (2, 1 if mode == "pallas" else 0)
        for name in ("rotations", "translations", "scales", "pred_boxes"):
            np.testing.assert_allclose(getattr(f_g, name),
                                       getattr(f_c, name), atol=1e-3,
                                       err_msg=name)


def test_detector_import_round_trip_on_the_card(tmp_path):
    """An import-mode detector on the card -> detectron2 .pth ->
    `import-torch-ckpt` on the card -> the port's checkpoint: every tensor
    bit-equal to the source."""
    from mot3d_tpu_torch import cli
    from mot3d_tpu_torch.config import Config
    from mot3d_tpu_torch.importers.torch_ckpt import import_config
    from mot3d_tpu_torch.importers.torch_export import (
        export_detectron2_maskrcnn, save_torch_state_dict)
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN

    dev = _cuda()
    cfg = Config()
    det = import_config(cfg.detection)
    src = MaskRCNN(det, device=dev)
    with torch.no_grad():   # the reference's voxel decoder is bias-free
        for name, p in src.voxel_head.named_parameters():
            if name.endswith("bias") and name.startswith("ConvTranspose_"):
                p.zero_()
    save_torch_state_dict(str(tmp_path / "m.pth"),
                          export_detectron2_maskrcnn(src.state_dict(), det))
    cli.main(["import-torch-ckpt", "--pth", str(tmp_path / "m.pth"), "--out",
              str(tmp_path / "out")])
    got = cli._init_detector(cfg.replace(detection=det),
                             str(tmp_path / "out"), dev).state_dict()
    want = src.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].is_cuda and torch.equal(got[k], v), k


def test_siamese_step_on_the_card_matches_the_cpu(tmp_path):
    """One siamese train step on two synthetic sequences on the card and on
    the CPU from the same weights, with SGD at LR 1 (the new parameters are
    the old ones minus the gradient; Adam's first step would turn rounding
    of near-zero gradients into +-lr) and TF32 off: the same loss and
    parameters within 1e-5 (float32, other summation orders)."""
    from mot3d_tpu.config import Config as ConfigJ
    from mot3d_tpu.config import TrackingConfig
    from mot3d_tpu.data.synthetic import synthetic_sequence
    from mot3d_tpu_torch.train.siamese_trainer import (SiameseTrainer,
                                                       SiameseTrainState)
    from mot3d_tpu_torch.train.tracking_trainer import sequences_to_batch
    from torch_port_helpers import port_config

    dev = _cuda()
    cfg = port_config(ConfigJ().replace(tracking=TrackingConfig(
        seq_len=3, max_instances_per_frame=4, max_frame_dist=1)))
    seqs = [{k: np.asarray(v) for k, v in synthetic_sequence(
        TrackingConfig(seq_len=3, max_instances_per_frame=4), seed=i,
        num_objects=3)._asdict().items()} for i in range(2)]
    out, tf32 = {}, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for d in ("cpu", dev):
            st = SiameseTrainer(cfg, str(tmp_path / str(d)), device=d)
            opt = torch.optim.SGD(st.model.parameters(), lr=1.0)
            state = SiameseTrainState(st.model, opt,
                                      torch.optim.lr_scheduler.LambdaLR(
                                          opt, lambda n: 1.0))
            state, metrics = st._step(False)(state, sequences_to_batch(seqs))
            out[str(d)] = (float(metrics["siamese_loss"]),
                           {k: v.cpu() for k, v in
                            st.model.state_dict().items()})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (l_c, p_c), (l_g, p_g) = out["cpu"], out["cuda"]
    assert np.isfinite(l_g) and abs(l_g - l_c) <= 1e-5
    for k, v in p_c.items():
        np.testing.assert_allclose(p_g[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)


def _tiny_office_cfg():
    from mot3d_tpu_torch.config import apply_overrides, default_config
    from torch_port_helpers import OFFICE_TINY
    return apply_overrides(default_config(), OFFICE_TINY)


def test_office_frame_on_the_card_matches_the_cpu(tmp_path):
    """One office frame through `office_inference` in both tracker modes on
    the card and on the CPU, the same weights (mask predictor raised so
    masks pass 0.5) and draws, TF32 off: the same detections, locations
    within 1e-3 (float32 fits summed in another order), K1 twice per frame
    in heuristic mode and never in F2F mode."""
    from mot3d_tpu_torch.data.fixtures import write_office_fixture
    from mot3d_tpu_torch.data.office import OfficeDataset, office_inference
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.ops.cuda import knn_outlier as k1

    dev = _cuda()
    cfg = _tiny_office_cfg()
    write_office_fixture(str(tmp_path), 1, 1, seed=3, hw=(128, 128),
                         intrinsics=(128.0, 128.0, 63.5, 63.5))
    ds = OfficeDataset(str(tmp_path), (64, 64))
    torch.manual_seed(0)
    model = MaskRCNN(cfg.detection, device="cpu")
    with torch.no_grad():
        model.mask_head.Conv_4.bias.fill_(3.0)
    draws = torch.randint(0, 2**31 - 1, (1, cfg.detection.detections_per_image,
                                         cfg.pose.ransac_iters,
                                         cfg.pose.ransac_sample_size),
                          generator=torch.Generator().manual_seed(0))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for mode in ("heuristic", "f2f"):
            out = {}
            for d in ("cpu", dev):
                k1.launches.reset()
                m = MaskRCNN(cfg.detection, device=d)
                m.load_state_dict(model.state_dict())
                _, frames = office_inference(cfg, m, ds, "scene00",
                                             tracker=mode, device=d,
                                             draws=draws)
                out[str(d)] = (frames[0], k1.launches.count)
            (f_c, _), (f_g, n1) = out["cpu"], out["cuda"]
            assert n1 == (2 if mode == "heuristic" else 0)
            assert len(f_g) == len(f_c) >= 1
            for a, b in zip(f_g, f_c):
                assert a["cls"] == b["cls"]
                np.testing.assert_allclose(a["loc"], b["loc"], atol=1e-3)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_bf16_predict_on_the_card():
    """The tiny detector at detection.compute_dtype="bfloat16" on the card:
    float32 parameters, finite float32 outputs, FPN features within 0.3
    (relative L2) of the float32 model's on the same weights (random
    weights grow bf16 rounding through the 53 layers: 0.14-0.19 on the
    CPU, tests/test_torch_port_detector.py)."""
    import dataclasses

    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN

    dev = _cuda()
    cfg = _tiny_office_cfg().detection
    torch.manual_seed(0)
    m32 = MaskRCNN(cfg, device=dev)
    m16 = MaskRCNN(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                   device=dev)
    m16.load_state_dict(m32.state_dict())
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    img = torch.rand(2, cfg.pad_height, cfg.pad_width, 3,
                     generator=torch.Generator().manual_seed(1)).to(dev) * 255
    with torch.no_grad():
        for a, b in zip(m16.features(img), m32.features(img)):
            assert a.dtype == torch.float32
            assert float((a - b).norm() / b.norm()) <= 0.3
    dets = m16.predict(img)
    for name in ("boxes", "scores", "masks", "voxels", "nocs"):
        t = getattr(dets, name)
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())


def _rel_err(got: dict, want: dict) -> float:
    """The largest per-tensor |got - want|_max / |want|_max."""
    return max(float((got[n].cpu() - w.detach().cpu()).abs().max())
               / max(float(w.detach().abs().max()), 1e-30)
               for n, w in want.items())


def test_two_ranks_on_the_card_match_one_process(tmp_path):
    """Two ranks of `_torch_parallel_worker.py` on the card (NCCL with a
    card each, gloo when they share one) against this process's steps on
    the global batches, float32 under deterministic algorithms: tracking
    and combined gradients (all three modes) within 1e-5 of each tensor's
    largest value (only the order of the sums differs), parameters
    bit-equal across the ranks, sharded serving equal to the unsharded run
    (identities, validity and classes exactly, the rest within 1e-4)."""
    import copy

    from mot3d_tpu_torch.data.synthetic import synthetic_sequence
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.models.mpn import TrackerModel
    from mot3d_tpu_torch.parallel import dryrun
    from mot3d_tpu_torch.parallel import train_step as ts
    from mot3d_tpu_torch.parallel.infer_step import (SequenceBatch,
                                                     make_sequence_infer_step)
    from mot3d_tpu_torch.tracking.graph_builder import make_template
    from mot3d_tpu_torch.train.combined_trainer import (detection_optimizer,
                                                        tracking_optimizer)
    from mot3d_tpu_torch.train.tracking_trainer import sequences_to_batch
    from torch_port_helpers import (COMBINED_MODES, finish_ranks,
                                    serving_inputs, start_ranks)

    dev = _cuda()
    cfg = dryrun.open_gates(dryrun.tiny_config())
    trk_c = cfg.tracking
    tmpl_t = make_template(trk_c.seq_len, trk_c.max_instances_per_frame,
                           trk_c.max_frame_dist)
    torch.manual_seed(2)
    tracker = TrackerModel(cfg.graph, device="cpu")
    tbatch = sequences_to_batch([synthetic_sequence(
        trk_c, seed=i, num_objects=3, noise=0.01)._asdict()
        for i in range(4)])
    tracking = dict(cfg=cfg, template=tmpl_t, model=tracker,
                    batch=tbatch._asdict())
    torch.manual_seed(0)
    det = MaskRCNN(cfg.detection, device="cpu")
    trk = TrackerModel(cfg.graph, device="cpu")
    with torch.no_grad():
        det.mask_head.Conv_4.bias.fill_(3.0)
    tmpl_c = make_template(trk_c.seq_len, cfg.detection.detections_per_image,
                           trk_c.max_frame_dist)
    combined = dict(cfg=cfg, det=det, trk=trk, template=tmpl_c,
                    batch=dryrun.dryrun_batch(cfg, 2), modes=COMBINED_MODES,
                    seed=11)
    serving = serving_inputs()
    procs = start_ranks(tmp_path, {"tracking": tracking,
                                   "combined": combined,
                                   "serving": serving}, device="cuda")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model = copy.deepcopy(tracker).to(dev)
        opt = torch.optim.SGD(model.parameters(), lr=1.0)
        state = ts.TrackingTrainState(model, opt, torch.optim.lr_scheduler.
                                      LambdaLR(opt, lambda n: 1.0))
        _, m = ts.make_tracking_train_step(model, tmpl_t, cfg, device=dev)(
            state, tbatch)
        ref_tracking = (float(m["tracking_loss"]),
                        dict(model.named_parameters()))
        ref_combined = {}
        for mode, kw in COMBINED_MODES.items():
            d, t = copy.deepcopy(det).to(dev), copy.deepcopy(trk).to(dev)
            step = ts.make_combined_train_step(d, t, tmpl_c, cfg,
                                               remat=False, device=dev, **kw)
            step(ts.CombinedTrainState(d, *detection_optimizer(cfg, d), t,
                                       *tracking_optimizer(cfg, t)),
                 ts.CombinedBatch(**combined["batch"]),
                 generator=torch.Generator(dev).manual_seed(11))
            ref_combined[mode] = [{n: p.grad for n, p in x.named_parameters()}
                                  for x in (d, t)]
        serve = make_sequence_infer_step(
            copy.deepcopy(serving["det"]), copy.deepcopy(serving["trk"]),
            serving["template"], serving["cfg"], device=dev)
        ref_serving = serve(SequenceBatch(**serving["batch"]),
                            generator=torch.Generator(dev).manual_seed(7))
    finally:
        torch.use_deterministic_algorithms(prev)
        got = finish_ranks(procs, tmp_path)
    for out in got:
        assert out["initialised"] and out["size"] == 2
        assert out["backend"] == ("nccl" if torch.cuda.device_count() >= 2
                                  else "gloo")
        assert abs(float(out["tracking"]["loss"]) - ref_tracking[0]) <= \
            1e-5 * abs(ref_tracking[0])
        assert _rel_err(out["tracking"]["params"], ref_tracking[1]) <= 1e-5
        for mode in COMBINED_MODES:
            for m in (0, 1):
                assert _rel_err(out["combined"][mode]["grads"][m],
                                ref_combined[mode][m]) <= 1e-5, mode
        for name in ("obj_ids", "valid", "classes"):
            assert torch.equal(out["serving"][name],
                               getattr(ref_serving, name).cpu()), name
        for name in ("translations", "scores", "edge_probs"):
            assert float((out["serving"][name] - getattr(
                ref_serving, name).cpu()).abs().max()) <= 1e-4, name
    for a, b in zip(got[0]["tracking"]["params"].values(),
                    got[1]["tracking"]["params"].values()):
        assert torch.equal(a, b)
    for mode in COMBINED_MODES:
        for m in (0, 1):
            for name, p in got[0]["combined"][mode]["params"][m].items():
                assert torch.equal(
                    p, got[1]["combined"][mode]["params"][m][name]), name


def test_world_one_nccl_dry_run():
    """The package's dry run on one rank of CUDA: a world-size-1 NCCL
    group, whose all_reduce runs through NCCL even on one card."""
    from mot3d_tpu_torch.parallel import dryrun

    _cuda()
    out = dryrun.dryrun_multichip(1, device="cuda")
    assert out["backend"] == "nccl" and out["device"] == "cuda:0"
    assert out["combined"]["tracking_loss"] > 0
    assert out["tracking"]["tracking_loss"] > 0
