"""Parity of the port's training path against the JAX package, on the CPU.

Every loss is compared in value and input gradient (`jax.value_and_grad`
against `torch.autograd`) in float64, with the JAX side under
`jax.enable_x64`: the sampler draws of both sides come from the same keys
(the port takes them as inputs), so the discrete decisions (labels,
samples, top-k) must be equal and the values agree to rounding.  Tolerance
rtol 1e-9, atol 1e-12 unless a test states another.

The whole slice: the JAX combined step's own `window_grad_fn` (remat off,
one compile under `jax.jit` in a module-scoped fixture) against the port's
at the tiny config, float64, the same weights (`importers/flax_params.py`)
and the same draws; gates open as `__graft_entry__.dryrun_multichip` opens
them, so the tracking loss is real.  As in test_torch_port_infer.py the
mask predictor is sharpened (mask probabilities away from the 0.5
extraction threshold) and the NOCS head is constant (each Umeyama fit the
well-posed centroid of its kept points: random NOCS give near-tied RANSAC
hypotheses).  The flax heads cast their outputs to float32
(`.astype(jnp.float32)`), so even under x64 the JAX voxel and NOCS losses
and every cotangent through a head output are float32: losses rtol 1e-5,
gradients within 2e-5 of each leaf's scale (`_assert_grads`).  One AdamW
update from the same params and gradients against `optax.adamw`, rtol
1e-12.  The pose tail has no such cast: its gradients agree to 1e-8.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _tiny_config
from mot3d_tpu.models import mask_rcnn as mrcnn_j
from mot3d_tpu.models import mpn as mpn_j
from mot3d_tpu.models import nocs_head as nocs_j
from mot3d_tpu.models import rpn as rpn_j
from mot3d_tpu.models import voxel_head as vox_j
from mot3d_tpu.parallel import train_step as ts_j
from mot3d_tpu.pose.pipeline import postprocess_frame as post_j
from mot3d_tpu.tracking.graph_builder import build_graph as graph_j
from mot3d_tpu.tracking.graph_builder import make_template as template_j
from mot3d_tpu.train.schedules import warmup_multistep as sched_j
from mot3d_tpu_torch.data.samples import DetectionSample
from mot3d_tpu_torch.importers.flax_params import (adamw_state_dict,
                                                   mask_rcnn_state_dict,
                                                   tracker_state_dict)
from mot3d_tpu_torch.models import mask_rcnn as mrcnn_t
from mot3d_tpu_torch.models import mpn as mpn_t
from mot3d_tpu_torch.models import nocs_head as nocs_t
from mot3d_tpu_torch.models import rpn as rpn_t
from mot3d_tpu_torch.models import voxel_head as vox_t
from mot3d_tpu_torch.models.mask_rcnn import DetectionDraws, MaskRCNN
from mot3d_tpu_torch.models.mpn import TrackerModel
from mot3d_tpu_torch.ops.cuda import pose_extract as k2
from mot3d_tpu_torch.parallel import train_step as ts_t
from mot3d_tpu_torch.pose.extraction import grid_extract
from mot3d_tpu_torch.pose.pipeline import postprocess_frames as post_t
from mot3d_tpu_torch.tracking.graph_builder import build_graph as graph_t
from mot3d_tpu_torch.tracking.graph_builder import make_template
from mot3d_tpu_torch.train.checkpoints import CheckpointManager
from mot3d_tpu_torch.train.combined_trainer import (CombinedTrainer,
                                                    detection_optimizer,
                                                    tracking_optimizer)
from mot3d_tpu_torch.train.schedules import warmup_multistep
from test_torch_port_pose import _scene
from torch_port_helpers import (port_config, random_params, sequence_draws,
                                slot_draws, to_torch)

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12
f64 = functools.partial(jax.tree_util.tree_map,
                        lambda a: np.asarray(a, np.float64))


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _boxes(rng, shape, extent=64.0, size=(6.0, 30.0)):
    xy = rng.uniform(0, extent - size[1], shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(*size, shape + (2,))], -1)


# ----------------------------------------------------------- the losses


@pytest.mark.parametrize("case", ["gt", "empty_gt"])
def test_rpn_targets_and_losses_match_jax(case):
    """label_anchors, subsample_labels (injected draws) and rpn_losses on
    two images: labels and matched boxes exactly, the two losses and their
    gradients in objectness and deltas to rtol 1e-9."""
    det = _tiny_config().detection
    anchors = rpn_t.generate_anchors(64, 64, tuple(det.anchor_sizes),
                                     tuple(det.anchor_ratios))
    a = anchors.shape[0]
    rng = np.random.default_rng(0)
    gt = _boxes(rng, (2, 3))
    valid = np.array([[True, True, False], [True, False, True]])
    if case == "empty_gt":
        valid[:] = False
    obj = rng.normal(size=(2, a)) * 3
    deltas = rng.normal(size=(2, a, 4)) * 0.3
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    with jax.enable_x64(True):
        rand = np.stack([np.asarray(jax.random.uniform(k, (a,)))
                         for k in keys])
        tj = jax.jit(jax.vmap(lambda g, v: rpn_j.label_anchors(
            jnp.asarray(anchors), g, v, det.rpn_pos_iou,
            det.rpn_neg_iou)))(jnp.asarray(gt), jnp.asarray(valid))
        sel_j = jax.jit(jax.vmap(lambda lab, k: rpn_j.subsample_labels(
            lab, k, det.rpn_batch_per_image, det.rpn_positive_fraction)))(
            tj.labels, keys)

        def loss_j(o, d):
            ol, bl = jax.vmap(lambda o_, d_, t, k: rpn_j.rpn_losses(
                o_, d_, jnp.asarray(anchors, jnp.float64), t, k,
                det.rpn_batch_per_image, det.rpn_positive_fraction))(
                o, d, tj, keys)
            return ol.sum() + 2.0 * bl.sum(), (ol, bl)

        (lj, (olj, blj)), gj = jax.jit(jax.value_and_grad(
            loss_j, argnums=(0, 1), has_aux=True))(jnp.asarray(obj),
                                                   jnp.asarray(deltas))

    anc_t = torch.from_numpy(anchors).double()
    tt = rpn_t.label_anchors(anc_t, to_torch(gt), to_torch(valid),
                             det.rpn_pos_iou, det.rpn_neg_iou)
    np.testing.assert_array_equal(tt.labels.numpy(), np.asarray(tj.labels))
    np.testing.assert_array_equal(tt.matched_boxes.numpy(),
                                  np.asarray(tj.matched_boxes))
    sel_t = rpn_t.subsample_labels(tt.labels, to_torch(rand),
                                   det.rpn_batch_per_image,
                                   det.rpn_positive_fraction)
    for got, want in zip(sel_t, sel_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(sel_t[0].sum() + sel_t[1].sum()) > 0
    o_t = to_torch(obj).requires_grad_()
    d_t = to_torch(deltas).requires_grad_()
    olt, blt = rpn_t.rpn_losses(o_t, d_t, anc_t, tt, to_torch(rand),
                                det.rpn_batch_per_image,
                                det.rpn_positive_fraction)
    (olt.sum() + 2.0 * blt.sum()).backward()
    _close(olt, olj)
    _close(blt, blj)
    _close(o_t.grad, gj[0])
    _close(d_t.grad, gj[1])


@pytest.mark.parametrize("case", ["gt", "empty_gt"])
def test_sample_rois_matches_jax(case):
    """Every field of the sampled ROIs equal, the positives first."""
    det = _tiny_config().detection
    rng = np.random.default_rng(1)
    p, m = 32, det.max_instances
    gt = _boxes(rng, (2, m))
    props = np.concatenate([gt[:, :, None] + rng.normal(
        0, 1.0, (2, m, 4, 4)), _boxes(rng, (2, m, 4))], 2).reshape(2, -1, 4)
    props = np.concatenate([props, _boxes(rng, (2, p - props.shape[1]))], 1)
    pvalid = rng.uniform(size=(2, p)) < 0.9
    gvalid = np.ones((2, m), bool)
    gvalid[1, 2] = False
    if case == "empty_gt":
        gvalid[:] = False
    classes = rng.integers(0, det.num_classes, (2, m)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    with jax.enable_x64(True):
        want = jax.jit(jax.vmap(lambda *a: mrcnn_j.sample_rois(*a, det)))(
            *map(jnp.asarray, (props, pvalid, gt, classes, gvalid)), keys)
        rand = np.stack([np.asarray(jax.random.uniform(k, (p + m,)))
                         for k in keys])
    got = mrcnn_t.sample_rois(*map(to_torch, (props, pvalid, gt, classes,
                                              gvalid, rand)), det)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    if case == "gt":
        assert got.is_pos.sum() >= 4


@pytest.mark.parametrize("case", ["mixed", "all_invalid"])
def test_voxel_loss_matches_jax(case):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5, 32, 32, 32)) * 2
    gt = (rng.uniform(size=(5, 32, 32, 32)) < 0.3).astype(np.float64)
    w = np.float64([1, 0, 1, 1, 0]) if case == "mixed" else np.zeros(5)
    with jax.enable_x64(True):
        (lj, iou_j), gj = jax.jit(jax.value_and_grad(
            lambda x: vox_j.voxel_loss(x, jnp.asarray(gt), jnp.asarray(w)),
            has_aux=True))(jnp.asarray(logits))
    x = to_torch(logits).requires_grad_()
    lt, iou_t = vox_t.voxel_loss(x, to_torch(gt), to_torch(w))
    lt.backward()
    _close(lt, lj)
    _close(iou_t, iou_j)
    _close(x.grad, gj)


def _nocs_case(rng, n=6):
    """Pred/GT boxes that overlap, one pair that does not (invalid), the
    symmetric class 1 among the classes, and GT patches with white
    background pixels."""
    gt_boxes = _boxes(rng, (n,))
    pred_boxes = gt_boxes + rng.normal(0, 3.0, (n, 4))
    pred_boxes[-1] = [0, 0, 5, 5]
    gt_boxes[-1] = [40, 40, 60, 60]
    gt = rng.uniform(size=(n, 28, 28, 3))
    gt[:, :4, :4] = 1.0
    classes = np.int32([1, 0, 1, 3, 2, 1])[:n]
    return pred_boxes, gt_boxes, gt, classes


@pytest.mark.parametrize("case", ["mixed", "all_invalid"])
def test_nocs_losses_match_jax(case):
    """nocs_loss (regression) and nocs_bin_loss (8 bins) with their
    gradients in the predicted patches / logits."""
    rng = np.random.default_rng(3)
    pred_boxes, gt_boxes, gt, classes = _nocs_case(rng)
    w = np.float64([1, 1, 0, 1, 1, 1]) if case == "mixed" else np.zeros(6)
    pred = rng.uniform(size=(6, 28, 28, 3))
    logits = rng.normal(size=(6, 28, 28, 3, 8))
    args = (gt, pred_boxes, gt_boxes, classes, w)
    with jax.enable_x64(True):
        ja = [jnp.asarray(a) for a in args]
        sym = jnp.asarray([1], jnp.int32)
        lj, gj = jax.jit(jax.value_and_grad(lambda x: nocs_j.nocs_loss(
            x, *ja, sym)))(jnp.asarray(pred))
        bj, gbj = jax.jit(jax.value_and_grad(lambda x: nocs_j.nocs_bin_loss(
            x, *ja, sym, num_bins=8)))(jnp.asarray(logits))
    ta = [to_torch(a) for a in args]
    x = to_torch(pred).requires_grad_()
    lt = nocs_t.nocs_loss(x, *ta, (1,))
    lt.backward()
    y = to_torch(logits).requires_grad_()
    bt = nocs_t.nocs_bin_loss(y, *ta, (1,), num_bins=8)
    bt.backward()
    for got, want in ((lt, lj), (x.grad, gj), (bt, bj), (y.grad, gbj)):
        _close(got, want)
    if case == "mixed":
        assert float(lt) > 0 and float(bt) > 0


@pytest.mark.parametrize("case", ["mixed", "empty_mask", "all_positive"])
def test_tracker_losses_match_jax(case):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 40)) * 2
    targets = (rng.uniform(size=40) < 0.3).astype(np.float64)
    mask = rng.uniform(size=40) < 0.8
    if case == "empty_mask":
        mask[:] = False
    if case == "all_positive":
        targets[:] = 1.0
    with jax.enable_x64(True):
        lj, gj = jax.jit(jax.value_and_grad(lambda x: mpn_j.tracker_loss(
            x, jnp.asarray(targets), jnp.asarray(mask))))(jnp.asarray(logits))
        bj = mpn_j.balanced_bce_loss(jnp.asarray(logits[0]),
                                     jnp.asarray(targets), jnp.asarray(mask))
    x = to_torch(logits).requires_grad_()
    lt = mpn_t.tracker_loss(x, to_torch(targets), to_torch(mask))
    lt.backward()
    _close(lt, lj)
    _close(x.grad, gj)
    _close(mpn_t.balanced_bce_loss(to_torch(logits[0]), to_torch(targets),
                                   to_torch(mask)), bj)


# ------------------------------------------------------- the whole slice


def _open_gates(cfg):
    return cfg.replace(
        combined=dataclasses.replace(cfg.combined, objectness_thres=-1.0,
                                     iou2d_thres=-1.0),
        pose=dataclasses.replace(cfg.pose, min_inlier_ratio=0.0),
        tracking=dataclasses.replace(cfg.tracking, box_iou_thres=0.0))


def _window(cfg, seed=0):
    """One 2-frame window at the tiny config: GT boxes inside the image
    with rectangle masks, random voxels and NOCS crops, one large GT 3D box
    around everything the camera sees (so identity matching has a clear
    winner) and identities rolled per frame (negative cross-frame edges:
    a balanced BCE with pos_weight 1)."""
    det = cfg.detection
    t, m, h = cfg.combined.batch_size, det.max_instances, det.pad_height
    rng = np.random.default_rng(seed)
    boxes = np.stack([_boxes(rng, (m,), extent=60.0, size=(12.0, 28.0))
                      for _ in range(t)]).round(1)
    masks = np.zeros((t, m, h, h))
    for f in range(t):
        for j, (x0, y0, x1, y1) in enumerate(boxes[f]):
            masks[f, j, int(y0) + 1:int(y1), int(x0) + 1:int(x1)] = 1.0
    lo, hi = np.float64([-3.0, -3.0, -3.2]), np.float64([3.0, 3.0, -0.8])
    signs = np.array([[1, 1, 1], [1, 1, -1], [-1, 1, -1], [-1, 1, 1],
                      [1, -1, 1], [1, -1, -1], [-1, -1, -1], [-1, -1, 1]])
    big = (lo + hi) / 2 + signs * (hi - lo) / 2
    gt3d = np.repeat(np.stack([big, big + 10.0, big * 0.1 - 20.0])[None],
                     t, 0)
    return dict(
        images=rng.uniform(0, 255, (t, h, h, 3)),
        depth=rng.uniform(1, 3, (t, h, h)),
        campose=np.tile(np.eye(4), (t, 1, 1)), gt_boxes2d=boxes,
        gt_classes=rng.integers(0, det.num_classes, (t, m)).astype(np.int32),
        gt_valid=np.ones((t, m), bool), gt_masks=masks,
        gt_voxels=(rng.uniform(size=(t, m, 32, 32, 32)) < 0.3).astype(
            np.float64),
        gt_nocs=rng.uniform(size=(t, m, 28, 28, 3)), gt_boxes3d=gt3d,
        gt_ids=np.stack([np.roll(np.arange(m, dtype=np.int32), f)
                         for f in range(t)]))


def _weights(cfg):
    det, t = cfg.detection, cfg.combined.batch_size
    img = jnp.zeros((1, det.pad_height, det.pad_width, 3))
    det_params = random_params(mrcnn_j.MaskRCNN(det), img, seed=0,
                               method=mrcnn_j.MaskRCNN.predict)
    e2 = 2 * len(template_j(t, det.detections_per_image,
                            cfg.tracking.max_frame_dist).src_frame)
    trk_params = random_params(
        mpn_j.TrackerModel(cfg.graph),
        jnp.zeros((t * det.detections_per_image, 32, 32, 32)),
        jnp.zeros(e2, jnp.int32), jnp.zeros(e2, jnp.int32),
        jnp.zeros((e2, cfg.graph.edge_in_dim)), jnp.zeros(e2, bool), seed=1)
    det_params["params"]["mask_head"]["Conv_4"]["kernel"] *= 5.0
    det_params["params"]["nocs_head"]["ConvTranspose_3"]["kernel"] *= 0.0
    return det_params, trk_params


def _jax_draws(key, cfg, n_anchors, n_rois):
    """The draws the JAX window forward makes from `key`: split into a
    detection and a pose key; the detection key split per image into the
    RPN's and the ROI sampler's uniforms; the pose key into RANSAC draws
    per frame and slot."""
    t, det, p = cfg.combined.batch_size, cfg.detection, cfg.pose
    rng_det, rng_pose = jax.random.split(key)
    keys = jax.random.split(rng_det, 2 * t)
    rpn = np.stack([np.asarray(jax.random.uniform(k, (n_anchors,)))
                    for k in keys[:t]])
    roi = np.stack([np.asarray(jax.random.uniform(k, (n_rois,)))
                    for k in keys[t:]])
    ransac = sequence_draws(rng_pose, t, det.detections_per_image,
                            p.ransac_iters, p.ransac_sample_size)
    return ts_t.WindowDraws(DetectionDraws(to_torch(rpn), to_torch(roi)),
                            to_torch(ransac))


def _port_models(cfg_t, det_params, trk_params):
    det = MaskRCNN(cfg_t.detection, device="cpu")
    det.load_state_dict(mask_rcnn_state_dict(det_params, cfg_t))
    trk = TrackerModel(cfg_t.graph, device="cpu")
    trk.load_state_dict(tracker_state_dict(trk_params, cfg_t))
    return det.double(), trk.double()


@pytest.fixture(scope="module")
def jax_window():
    """The JAX step's window_grad_fn on one window, compiled once."""
    cfg = _open_gates(_tiny_config())
    det = cfg.detection
    t = cfg.combined.batch_size
    template = template_j(t, det.detections_per_image,
                          cfg.tracking.max_frame_dist)
    det_params, trk_params = _weights(cfg)
    win = _window(cfg)
    key = jax.random.PRNGKey(3)
    cfg_t = port_config(cfg)
    probe = MaskRCNN(cfg_t.detection, device="cpu")
    with jax.enable_x64(True):
        step = ts_j.make_combined_train_step(
            mrcnn_j.MaskRCNN(det), mpn_j.TrackerModel(cfg.graph), template,
            cfg, optax.sgd(1.0), optax.sgd(1.0), remat=False)
        (loss, aux), grads = jax.device_get(jax.jit(step.window_grad_fn)(
            (f64(det_params), f64(trk_params)),
            ts_j.CombinedBatch(**{k: jnp.asarray(v) for k, v in win.items()}),
            key))
        draws = _jax_draws(key, cfg, probe.anchors.shape[0],
                           probe.num_proposals_train() + det.max_instances)
    return dict(cfg=cfg, cfg_t=cfg_t, det_params=det_params,
                trk_params=trk_params, win=win, draws=draws, loss=loss,
                aux=aux, grads=grads)


@pytest.fixture(scope="module")
def port_window(jax_window):
    j = jax_window
    cfg_t = j["cfg_t"]
    det, trk = _port_models(cfg_t, j["det_params"], j["trk_params"])
    step = ts_t.make_combined_train_step(
        det, trk, make_template(cfg_t.combined.batch_size,
                                cfg_t.detection.detections_per_image,
                                cfg_t.tracking.max_frame_dist),
        cfg_t, remat=False, device="cpu")
    (loss, aux), grads = step.window_grad_fn(
        ts_t.CombinedBatch(**{k: to_torch(v) for k, v in j["win"].items()}),
        j["draws"])
    return dict(det=det, trk=trk, loss=loss, aux=aux, grads=grads)


def test_jax_window_trains_the_tracker(jax_window):
    """The reference side of the whole-slice comparison really runs the
    tracking tail: open gates give a non-empty graph with negative edges,
    so the tracking loss and the tracker's gradient are non-zero."""
    _, tl, losses = jax_window["aux"]
    assert float(tl) > 0 and np.isfinite(list(losses.values())).all()
    g_trk = jax_window["grads"][1]
    assert sum(float(np.abs(x).sum())
               for x in jax.tree_util.tree_leaves(g_trk)) > 0


def test_window_losses_match_jax(jax_window, port_window):
    """The loss dict (same keys), detection total, tracking loss and their
    sum; the tracking loss is real (open gates, negative edges)."""
    lj, (tot_j, tl_j, dl_j) = jax_window["loss"], jax_window["aux"]
    lt, (tot_t, tl_t, dl_t) = port_window["loss"], port_window["aux"]
    assert set(dl_t) == set(dl_j)
    for k in dl_j:
        _close(dl_t[k], dl_j[k], rtol=1e-5, what=k)
    _close(tot_t, tot_j, rtol=1e-5)
    _close(tl_t, tl_j, rtol=1e-5)
    _close(lt, lj, rtol=1e-5)
    assert float(tl_t) > 0 and float(dl_t["loss_nocs"]) > 0


def _assert_grads(got: dict, want: dict, tol=2e-5, floor=1e-6):
    """Each leaf elementwise within `tol` times its scale and within a
    relative L2 distance `tol`.  A leaf's scale is its largest element, but
    at least `floor` times the model's largest: a leaf whose true gradient
    is zero (a convolution bias right before a GroupNorm of one channel per
    group) holds rounding noise on both sides."""
    assert set(got) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        w = w.numpy()
        g = got[name].detach().numpy()
        scale = max(float(np.abs(w).max()), floor * top, 1e-300)
        _close(g, w, rtol=0, atol=tol * scale, what=name)
        assert np.linalg.norm(g - w) <= tol * max(
            np.linalg.norm(w), scale), name


def test_window_gradients_match_jax(jax_window, port_window):
    """Both models' gradients, mapped through `mask_rcnn_state_dict` /
    `tracker_state_dict`; with detached pose the tracking loss reaches the
    tracker only."""
    cfg_t = jax_window["cfg_t"]
    g_det, g_trk = jax_window["grads"]
    gd, gt = port_window["grads"]
    _assert_grads(gd, mask_rcnn_state_dict(g_det, cfg_t))
    _assert_grads(gt, tracker_state_dict(g_trk, cfg_t))
    assert sum(float(g.abs().sum()) for g in gt.values()) > 0


def test_adamw_update_matches_optax(jax_window, port_window):
    """One AdamW update of both models from the same params and the same
    (JAX's) gradients against `optax.adamw`, in float64 (rtol 1e-12).
    Adam's first step is lr * g / (|g| + eps): fed each side's own
    gradients, an element with |g| near eps would move by up to lr times
    the gradients' relative difference."""
    j, p = jax_window, port_window
    cfg_t = j["cfg_t"]
    c = cfg_t.combined
    opts = (optax.adamw(c.detection_lr, weight_decay=c.detection_weight_decay),
            optax.adamw(c.tracking_lr, weight_decay=c.tracking_weight_decay))
    with jax.enable_x64(True):
        @jax.jit
        def update(params, grads):
            return [optax.apply_updates(pp, o.update(g, o.init(pp), pp)[0])
                    for o, pp, g in zip(opts, params, grads)]

        want = jax.device_get(update(
            [f64(j["det_params"]), f64(j["trk_params"])],
            [f64(g) for g in j["grads"]]))
    for model, make, grads, w, to_sd in (
            (p["det"], detection_optimizer, j["grads"][0], want[0],
             mask_rcnn_state_dict),
            (p["trk"], tracking_optimizer, j["grads"][1], want[1],
             tracker_state_dict)):
        model = copy.deepcopy(model)
        gsd = to_sd(f64(grads), cfg_t)
        for name, param in model.named_parameters():
            param.grad = gsd[name]
        opt, sched = make(cfg_t, model)
        opt.step()
        sched.step()
        want_sd = to_sd(w, cfg_t)
        for name, param in model.named_parameters():
            _close(param, want_sd[name], rtol=1e-12, atol=1e-15, what=name)


# ------------------------------------------- differentiable pose tail


@pytest.mark.parametrize("solver", ["quat", "svd"])
def test_differentiable_pose_tail_gradient_matches_jax(solver):
    """pose (differentiable) -> build_graph -> TrackerModel ->
    tracker_loss on two well-posed frames (NOCS exact similarity images of
    the depth surface): the gradient in the NOCS patches and in the
    tracker's parameters against `jax.grad`, within 1e-8 of each leaf's
    scale (float64 throughout: the power-iterated or SVD rotation, the
    RANSAC refit on the inliers, the edge features)."""
    cfg = _tiny_config()
    cfg = cfg.replace(pose=dataclasses.replace(cfg.pose, differentiable=True,
                                               solver=solver))
    cfg_t = port_config(cfg)
    scenes = [_scene(seed=s) for s in (0, 1)]
    sc = {k: np.stack([s[k] for s in scenes]).astype(
        np.float64 if scenes[0][k].dtype == np.float32 else scenes[0][k].dtype)
        for k in scenes[0]}
    t, i = 2, sc["det_boxes"].shape[1]
    gt_ids = np.tile(np.arange(3, dtype=np.int32), (t, 1))
    template = template_j(t, i, 1)
    e2 = 2 * len(template.src_frame)
    trk_params = random_params(
        mpn_j.TrackerModel(cfg.graph), jnp.zeros((t * i, 32, 32, 32)),
        jnp.zeros(e2, jnp.int32), jnp.zeros(e2, jnp.int32),
        jnp.zeros((e2, cfg.graph.edge_in_dim)), jnp.zeros(e2, bool), seed=2)
    intr = np.array([[64.0, 0, 31.5], [0, 64.0, 31.5], [0, 0, 1]])
    names = ("det_boxes", "det_scores", "det_classes", "det_valid",
             "det_masks", "det_voxels")
    key = jax.random.PRNGKey(9)
    trk_j = mpn_j.TrackerModel(cfg.graph)

    def loss_j(nocs, params):
        keys = jax.random.split(key, t)
        fr = jax.vmap(lambda f: post_j(
            *(jnp.asarray(sc[n])[f] for n in names), nocs[f],
            jnp.asarray(sc["gt_boxes2d"])[f], jnp.asarray(sc["gt_valid"])[f],
            jnp.asarray(sc["depth"])[f], jnp.asarray(sc["campose"])[f],
            jnp.asarray(intr), jnp.asarray(sc["gt_boxes3d_cropped"])[f],
            keys[f], cfg))(jnp.arange(t))
        g = graph_j(template, cfg.tracking, fr.valid, fr.translations,
                    fr.rotations, fr.scales, fr.pred_boxes,
                    jnp.asarray(sc["gt_boxes3d_cropped"]),
                    jnp.asarray(gt_ids), jnp.asarray(sc["gt_valid"]))
        logits = trk_j.apply(params, fr.voxels.reshape(-1, 32, 32, 32),
                             g.src, g.dst, g.edge_attr, g.edge_mask)
        return mpn_j.tracker_loss(logits, g.targets, g.edge_mask)

    with jax.enable_x64(True):
        lj, (g_nocs, g_par) = jax.jit(jax.value_and_grad(
            loss_j, argnums=(0, 1)))(jnp.asarray(sc["det_nocs"]),
                                     f64(trk_params))
        g_nocs, g_par = jax.device_get((g_nocs, g_par))
        draws = np.stack([slot_draws(k, i, cfg.pose.ransac_iters,
                                     cfg.pose.ransac_sample_size)
                          for k in jax.random.split(key, t)])

    trk = TrackerModel(cfg_t.graph, device="cpu")
    trk.load_state_dict(tracker_state_dict(trk_params, cfg_t))
    trk = trk.double()
    nocs = to_torch(sc["det_nocs"]).requires_grad_()
    fr = post_t(*(to_torch(sc[n]) for n in names), nocs,
                to_torch(sc["gt_boxes2d"]), to_torch(sc["gt_valid"]),
                to_torch(sc["depth"]), to_torch(sc["campose"]),
                to_torch(intr), to_torch(sc["gt_boxes3d_cropped"]), cfg_t,
                draws=to_torch(draws))
    g = graph_t(make_template(t, i, 1), cfg_t.tracking, fr.valid,
                fr.translations, fr.rotations, fr.scales, fr.pred_boxes,
                to_torch(sc["gt_boxes3d_cropped"]), to_torch(gt_ids),
                to_torch(sc["gt_valid"]))
    lt = mpn_t.tracker_loss(trk(fr.voxels.reshape(-1, 32, 32, 32), g.src,
                                g.dst, g.edge_attr, g.edge_mask),
                            g.targets, g.edge_mask)
    lt.backward()
    assert int(fr.valid.sum()) >= 4 and float(lt) > 0
    _close(lt, lj, rtol=1e-10)
    assert float(np.abs(g_nocs).max()) > 0
    _assert_grads({"nocs": nocs.grad}, {"nocs": torch.from_numpy(
        np.asarray(g_nocs))}, tol=1e-8)
    _assert_grads({n: p.grad for n, p in trk.named_parameters()},
                  tracker_state_dict(g_par, cfg_t), tol=1e-8)


@pytest.mark.parametrize("seed", [0])
def test_tracking_step_matches_jax(seed):
    """`make_tracking_train_step` against the JAX step on two synthetic
    sequences (`data/synthetic.py`), float64: one update with SGD at LR 1
    on both sides, so the new parameters are the old ones minus the
    gradient (rtol 1e-9), and the same tracking loss."""
    from mot3d_tpu.data.synthetic import synthetic_sequence

    cfg = _tiny_config()
    cfg_t = port_config(cfg)
    trk_cfg = cfg.tracking
    tmpl_args = (trk_cfg.seq_len, trk_cfg.max_instances_per_frame,
                 trk_cfg.max_frame_dist)
    seqs = [synthetic_sequence(trk_cfg, seed=seed + i, num_objects=3,
                               noise=0.01)._asdict() for i in range(2)]
    batch = {k: np.stack([np.asarray(sq[k]) for sq in seqs])
             for k in ts_j.TrackingBatch._fields}
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in batch.items()}
    e2 = 2 * len(template_j(*tmpl_args).src_frame)
    n = trk_cfg.seq_len * trk_cfg.max_instances_per_frame
    params = random_params(
        mpn_j.TrackerModel(cfg.graph), jnp.zeros((n, 32, 32, 32)),
        jnp.zeros(e2, jnp.int32), jnp.zeros(e2, jnp.int32),
        jnp.zeros((e2, cfg.graph.edge_in_dim)), jnp.zeros(e2, bool), seed=4)
    with jax.enable_x64(True):
        sgd = optax.sgd(1.0)
        step_j = jax.jit(ts_j.make_tracking_train_step(
            mpn_j.TrackerModel(cfg.graph), template_j(*tmpl_args), cfg, sgd))
        p64 = f64(params)
        state, metrics = step_j(
            ts_j.TrackingTrainState(p64, sgd.init(p64), jnp.zeros((), int)),
            ts_j.TrackingBatch(**{k: jnp.asarray(v)
                                  for k, v in batch.items()}))
        want = jax.device_get(state.params)
        loss_j = float(metrics["tracking_loss"])

    model = TrackerModel(cfg_t.graph, device="cpu")
    model.load_state_dict(tracker_state_dict(params, cfg_t))
    model = model.double()
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    state_t = ts_t.TrackingTrainState(
        model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda n: 1.0))
    step_t = ts_t.make_tracking_train_step(
        model, make_template(*tmpl_args), cfg_t, device="cpu")
    state_t, metrics_t = step_t(state_t, ts_t.TrackingBatch(**batch))
    assert state_t.step == 1 and loss_j > 0
    _close(metrics_t["tracking_loss"], loss_j)
    want_sd = tracker_state_dict(want, cfg_t)
    for name, p in model.named_parameters():
        _close(p, want_sd[name], what=name)


# ------------------------------------------------------ port-only checks


def _tiny_port_cfg(**combined):
    cfg = _open_gates(_tiny_config())
    cfg = cfg.replace(combined=dataclasses.replace(cfg.combined, **combined))
    return port_config(cfg)


def _port_setup(cfg_t, seed=0):
    """float64 port models from torch's init (seeded), the mask predictor's
    bias raised so masks pass the 0.5 extraction threshold."""
    torch.manual_seed(seed)
    det = MaskRCNN(cfg_t.detection, device="cpu").double()
    trk = TrackerModel(cfg_t.graph, device="cpu").double()
    with torch.no_grad():
        det.mask_head.Conv_4.bias.fill_(3.0)
    return det, trk


def _state(cfg_t, det, trk):
    return ts_t.CombinedTrainState(det, *detection_optimizer(cfg_t, det),
                                   trk, *tracking_optimizer(cfg_t, trk))


def _batch(cfg, windows=2):
    wins = [_window(cfg, seed=s) for s in range(windows)]
    return ts_t.CombinedBatch(**{k: torch.from_numpy(
        np.stack([w[k] for w in wins])) for k in wins[0]})


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_joint_and_two_backward_give_equal_gradients():
    """With detached pose the joint single backward and the reference's two
    backwards (`backward(inputs=...)`) give the same gradients and
    metrics, to rounding (rtol 1e-12)."""
    cfg_t = _tiny_port_cfg()
    det, trk = _port_setup(cfg_t)
    batch = _batch(cfg_t)
    tmpl = make_template(2, cfg_t.detection.detections_per_image, 1)
    gen = torch.Generator().manual_seed(0)
    draws = ts_t.make_window_draws(det, cfg_t, 2, 2, gen)
    out = {}
    for joint in (True, False):
        d, t = copy.deepcopy(det), copy.deepcopy(trk)
        step = ts_t.make_combined_train_step(d, t, tmpl, cfg_t,
                                             joint_grad=joint, remat=False,
                                             device="cpu")
        _, metrics = step(_state(cfg_t, d, t), batch, draws)
        out[joint] = (_grads(d), _grads(t), metrics)
    assert float(out[True][2]["tracking_loss"]) > 0
    for k, v in out[True][2].items():
        _close(out[False][2][k], v.numpy(), rtol=1e-12, what=k)
    for a in (0, 1):
        for name, g in out[True][a].items():
            _close(out[False][a][name], g.numpy(), rtol=1e-12, atol=1e-15,
                   what=name)


def test_accum_windows_equals_window_mean_and_remat_recomputes(monkeypatch):
    """accum_windows (one window in flight) gives the mean of the per-window
    `window_grad_fn` gradients (rtol 1e-10); with remat the K1 statistic
    runs twice per window forward and twice more in its recomputation."""
    from mot3d_tpu_torch.geometry import outlier

    cfg_t = _tiny_port_cfg()
    det, trk = _port_setup(cfg_t, seed=1)
    batch = _batch(cfg_t)
    tmpl = make_template(2, cfg_t.detection.detections_per_image, 1)
    draws = ts_t.make_window_draws(det, cfg_t, 2, 2,
                                   torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="accum_windows"):
        ts_t.make_combined_train_step(det, trk, tmpl, cfg_t,
                                      joint_grad=False, accum_windows=True,
                                      device="cpu")
    step = ts_t.make_combined_train_step(det, trk, tmpl, cfg_t,
                                         accum_windows=True, device="cpu")
    oracle = [step.window_grad_fn(
        ts_t.CombinedBatch(*(x[i] for x in batch)),
        ts_t._window_draws(draws, i))[1] for i in range(2)]
    calls = []
    orig = outlier.knn_mean_dists

    def counting(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(outlier, "knn_mean_dists", counting)
    step(_state(cfg_t, det, trk), batch, draws)
    assert len(calls) == 2 * 2 * 2     # 2 windows x (forward + recompute)
    for m, model in ((0, det), (1, trk)):
        for name, p in model.named_parameters():
            want = (oracle[0][m][name] + oracle[1][m][name]) / 2
            _close(p.grad, want.numpy(), rtol=1e-10,
                   atol=1e-12 * max(float(want.abs().max()), 1e-30),
                   what=name)


@pytest.mark.parametrize("count", [0, 4, 10, 19, 20, 25, 30, 31])
def test_warmup_multistep_matches_jax(count):
    """At 0, during the warm-up, at its end, at and after each milestone
    (the JAX schedule computes in float32: rtol 1e-6)."""
    args = (8e-4, 10, 1e-3, (20, 30), 0.1)
    assert warmup_multistep(*args)(count) == pytest.approx(
        float(sched_j(*args)(count)), rel=1e-6)


def test_adamw_continues_an_optax_run():
    """Two optax.adamw steps, the state carried into torch's AdamW by
    `adamw_state_dict`, then three more steps on each side with the same
    gradients: equal parameters (float64, rtol 1e-10) and an equal LR
    schedule position."""
    cfg_t = _tiny_port_cfg(lr_warmup_iters=4, lr_warmup_factor=0.1)
    c = cfg_t.combined
    tmpl = template_j(2, 4, 1)
    e2 = 2 * len(tmpl.src_frame)
    params = f64(random_params(
        mpn_j.TrackerModel(cfg_t.graph), jnp.zeros((8, 32, 32, 32)),
        jnp.zeros(e2, jnp.int32), jnp.zeros(e2, jnp.int32),
        jnp.zeros((e2, 8)), jnp.zeros(e2, bool), seed=3))
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape), params)
             for _ in range(5)]
    sched = warmup_multistep(c.detection_lr, c.lr_warmup_iters,
                             c.lr_warmup_factor)
    with jax.enable_x64(True):
        # The JAX schedule in float64 (`sched_j` computes in float32).
        def schedule(n):
            n = n.astype(jnp.float64)
            return c.detection_lr * jnp.where(n < 4, 0.1 * (1.0 - n / 4)
                                              + n / 4, 1.0)

        opt = optax.adamw(schedule, weight_decay=1e-2)

        @jax.jit
        def update(g, state, params):
            upd, state = opt.update(g, state, params)
            return optax.apply_updates(params, upd), state

        state = opt.init(params)
        p_j = params
        for k, g in enumerate(grads):
            if k == 2:
                adam = state[0]
                carried = jax.device_get(dict(mu=adam.mu, nu=adam.nu,
                                              count=adam.count))
                p_mid = jax.device_get(p_j)
            p_j, state = update(g, state, p_j)
        p_j = jax.device_get(p_j)

    model = TrackerModel(cfg_t.graph, device="cpu").double()
    model.load_state_dict(tracker_state_dict(p_mid, cfg_t))
    topt, tsched = (lambda o: (o, torch.optim.lr_scheduler.LambdaLR(
        o, sched)))(torch.optim.AdamW(model.parameters(), lr=1.0,
                                      weight_decay=1e-2, eps=1e-8))
    topt.load_state_dict(adamw_state_dict(carried, model, topt))
    tsched.last_epoch = int(carried["count"])
    for group in topt.param_groups:
        group["lr"] = sched(int(carried["count"]))
    for g in grads[2:]:
        gsd = tracker_state_dict(g, cfg_t)
        for name, p in model.named_parameters():
            p.grad = gsd[name]
        topt.step()
        tsched.step()
    want = tracker_state_dict(p_j, cfg_t)
    for name, p in model.named_parameters():
        _close(p, want[name], rtol=1e-10, atol=1e-13, what=name)
    assert tsched.last_epoch == 5


def _samples(cfg_t, n=5, seed=0):
    """Frames of a short synthetic sequence as DetectionSamples."""
    win = [_window(cfg_t, seed=s) for s in range(n)]
    out = []
    for f, w in enumerate(win):
        m = w["gt_ids"].shape[1]
        out.append(DetectionSample(
            image=w["images"][0].astype(np.float32),
            depth=w["depth"][0].astype(np.float32),
            campose=w["campose"][0].astype(np.float32),
            boxes=w["gt_boxes2d"][0].astype(np.float32),
            classes=w["gt_classes"][0], valid=w["gt_valid"][0],
            masks=w["gt_masks"][0].astype(np.float32),
            voxels=w["gt_voxels"][0].astype(np.float32),
            nocs=w["gt_nocs"][0].astype(np.float32),
            boxes3d=w["gt_boxes3d"][0].astype(np.float32),
            object_ids=np.roll(np.arange(m, dtype=np.int32), f),
            locations=w["gt_boxes3d"][0].mean(1).astype(np.float32),
            rotations=np.zeros((m, 3), np.float32),
            scales3d=np.ones(m, np.float32)))
    return out


def _trainer(cfg_t, out_dir):
    tr = CombinedTrainer(cfg_t, str(out_dir), device="cpu")
    with torch.no_grad():
        tr.det_model.mask_head.Conv_4.bias.fill_(3.0)
    return tr


def test_combined_trainer_trains_and_tests_on_cpu(tmp_path):
    """Two steps through `CombinedTrainer.train` (an eval and a checkpoint
    on the way) and `do_test`: finite metrics, both models moved, the
    metrics file written."""
    cfg_t = _tiny_port_cfg(eval_period=2, checkpoint_period=1)
    frames = _samples(cfg_t, 3)
    tr = _trainer(cfg_t, tmp_path)
    before = [copy.deepcopy(m.state_dict()) for m in (tr.det_model,
                                                      tr.trk_model)]
    metrics = tr.train(iter([frames[0:2], frames[1:3], frames[0:2]]),
                       max_iter=2, test_seqs=[frames])
    assert tr.state.step == 2 and np.isfinite(list(metrics.values())).all()
    assert metrics["tracking_loss"] > 0
    for model, old in zip((tr.det_model, tr.trk_model), before):
        assert any(not torch.equal(v, old[k])
                   for k, v in model.state_dict().items())
    assert tr.ckpt.latest_step() == 2 and "mota" in tr.ckpt.best
    test = tr.do_test([frames])
    assert all(np.isfinite(v) for v in test.values())
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) >= 3


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    """Two steps, a checkpoint, a new trainer that resumes and takes the
    third step: the same parameters, optimizer moments and step as three
    uninterrupted steps (the draws of a step come from (seed, step))."""
    cfg_t = _tiny_port_cfg(checkpoint_period=2)
    frames = _samples(cfg_t, 4)
    wins = [frames[k:k + 2] for k in range(3)]
    a = _trainer(cfg_t, tmp_path / "a")
    a.train(iter(wins[:2]), max_iter=2)
    b = _trainer(cfg_t, tmp_path / "a")
    b.train(iter(wins[2:]), max_iter=3, resume=True)
    c = _trainer(cfg_t, tmp_path / "c")
    c.train(iter(wins), max_iter=3)
    assert b.state.step == c.state.step == 3
    sb, sc = b.state.state_dict(), c.state.state_dict()
    for name in ("det_model", "trk_model"):
        for k, v in sc[name].items():
            assert torch.equal(sb[name][k], v), (name, k)
    for name in ("det_opt", "trk_opt"):
        for i, st in sc[name]["state"].items():
            for k, v in st.items():
                assert torch.equal(sb[name]["state"][i][k], v)
    mgr = CheckpointManager(tmp_path / "a" / "ckpt", max_to_keep=1)
    assert mgr.all_steps() == [2] and not mgr.save(2, b.state)


# ---------------------------------------------------------- K2 and autograd


def test_k2_wrapper_refuses_a_gradient():
    """`pose_extract` runs inside a forward-only autograd function: on the
    CPU it gives the plain version's values, serves under no_grad, and its
    backward raises instead of returning a silent zero gradient."""
    rng = np.random.default_rng(6)
    nocs = torch.from_numpy(rng.uniform(size=(3, 28, 28, 3)).astype(
        np.float32)).requires_grad_()
    args = (torch.from_numpy(rng.uniform(size=(3, 28, 28)).astype(
        np.float32)), torch.tensor([[2.0, 3, 40, 50], [10, 10, 30, 60],
                                    [0, 0, 63, 63]]),
        torch.from_numpy(rng.uniform(1, 3, (64, 64)).astype(np.float32)),
        torch.tensor([[64.0, 0, 31.5], [0, 64.0, 31.5], [0, 0, 1]]))
    feats, valid = k2.pose_extract(nocs, *args, 16)
    want_f, want_v = grid_extract(nocs.detach(), *args, 16)
    assert torch.equal(feats.detach(), want_f) and torch.equal(valid, want_v)
    assert feats.requires_grad and not valid.requires_grad
    with pytest.raises(RuntimeError, match="K2 backward"):
        feats.sum().backward()
    with torch.no_grad():
        f2, _ = k2.pose_extract(nocs, *args, 16)
    assert torch.equal(f2, want_f) and not f2.requires_grad


def test_train_steps_refuse_pallas_extraction():
    """Both train steps refuse pose.extraction='pallas' when they are built
    (the JAX step fails to trace there)."""
    cfg = _tiny_config()
    cfg_t = port_config(cfg.replace(pose=dataclasses.replace(
        cfg.pose, extraction="pallas")))
    trk = TrackerModel(cfg_t.graph, device="cpu")
    tmpl = make_template(2, 4, 1)
    with pytest.raises(NotImplementedError, match="K2 backward"):
        ts_t.make_combined_train_step(None, trk, tmpl, cfg_t, device="cpu")
    with pytest.raises(NotImplementedError, match="K2 backward"):
        ts_t.make_tracking_train_step(trk, tmpl, cfg_t, device="cpu")
