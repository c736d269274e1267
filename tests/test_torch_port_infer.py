"""The whole slice end to end: JAX `make_sequence_infer_step` against the
port's, at the tiny config with B=1, the same weights (carried across by
`importers/flax_params.py`) and the same RANSAC draws, on the CPU.

As in test_torch_port_detector.py, both frameworks compute in float64 (JAX
under `jax.enable_x64`, the port's models after `.double()`): in float32
the random-weight detector's outputs drift by ~1e-3 px between XLA and
torch, and the pose stage downstream would then fit different points.
Comparison as tests/test_parallel.py does it: obj_ids, valid and classes
exact; translations, scores and edge_probs rtol = atol = 1e-4.

The second test walks the reference-parity evaluation path: the detector
in import mode (`import_config`, random affine scales and biases) with
exact NMS, then host assembly and MOTA on both sides from each side's own
outputs.  Trajectories must be equal (frames, identities and classes
exactly, locations to 1e-4) and not empty; MOTA summaries equal to 1e-12.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mot3d_tpu.importers.torch_ckpt import import_config as import_config_j
from mot3d_tpu.models.mask_rcnn import MaskRCNN as MaskRCNNJ
from mot3d_tpu.models.mpn import TrackerModel as TrackerJ
from mot3d_tpu.parallel.infer_step import SequenceBatch as BatchJ
from mot3d_tpu.parallel.infer_step import make_sequence_infer_step as step_j
from mot3d_tpu.tracking import Tracker as TrackerHostJ
from mot3d_tpu.tracking.graph_builder import make_template as template_j
from mot3d_tpu_torch.importers.flax_params import (mask_rcnn_state_dict,
                                                   tracker_state_dict)
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN as MaskRCNNT
from mot3d_tpu_torch.models.mpn import TrackerModel as TrackerT
from mot3d_tpu_torch.parallel.infer_step import SequenceBatch as BatchT
from mot3d_tpu_torch.parallel.infer_step import make_sequence_infer_step
from mot3d_tpu_torch.parallel.infer_step import outputs_to_host
from mot3d_tpu_torch.tracking.graph_builder import make_template
from mot3d_tpu_torch.tracking.tracker import Tracker as TrackerHostT
from torch_port_helpers import (jit_run, port_config, random_params,
                                randomise_affine, sequence_draws,
                                tame_affine_backbone)

torch.set_num_threads(1)


def _open_gates(cfg):
    """Every gate open (as __graft_entry__.dryrun_multichip does), so each
    detection slot of the random-weight detector flows through pose, graph
    identity and the MPN."""
    return cfg.replace(
        combined=dataclasses.replace(cfg.combined, objectness_thres=-1.0,
                                     iou2d_thres=-1.0),
        pose=dataclasses.replace(cfg.pose, min_inlier_ratio=0.0))


def _batch(cfg, seed=0):
    det, trk = cfg.detection, cfg.tracking
    t_frames, m = trk.seq_len, det.max_instances
    h = w = det.pad_height
    rng = np.random.default_rng(seed)
    boxes = np.zeros((1, t_frames, m, 4), np.float32)
    boxes[..., 2:] = 20.0
    boxes[..., 1, :] += 30.0
    # GT 3D boxes: one around every point the camera sees, two elsewhere,
    # so identity matching picks a clear winner.
    lo = np.float32([-3.0, -3.0, -3.2])
    hi = np.float32([3.0, 3.0, -0.8])
    signs = np.array([[1, 1, 1], [1, 1, -1], [-1, 1, -1], [-1, 1, 1],
                      [1, -1, 1], [1, -1, -1], [-1, -1, -1], [-1, -1, 1]],
                     np.float32)
    big = (lo + hi) / 2 + signs * (hi - lo) / 2
    gt3d = np.stack([big, big + 10.0, big * 0.1 - 20.0])[None, None]
    gt3d = np.repeat(gt3d, t_frames, 1).astype(np.float32)
    return dict(
        images=rng.uniform(0, 255, (1, t_frames, h, w, 3)).astype(np.float32),
        depth=rng.uniform(1, 3, (1, t_frames, h, w)).astype(np.float32),
        campose=np.tile(np.eye(4, dtype=np.float32), (1, t_frames, 1, 1)),
        gt_boxes2d=boxes, gt_valid2d=np.ones((1, t_frames, m), bool),
        gt_boxes3d=gt3d, gt_boxes3d_cropped=gt3d,
        gt_ids=np.tile(np.arange(m, dtype=np.int32) + 3, (1, t_frames, 1)),
        gt_valid=np.ones((1, t_frames, m), bool))


def _import_mode(cfg):
    return cfg.replace(detection=dataclasses.replace(
        import_config_j(cfg.detection), fast_nms=False))


@functools.lru_cache(maxsize=2)
def _weights(import_mode=False):
    cfg = _import_mode(_tiny_config()) if import_mode else _tiny_config()
    det, trk = cfg.detection, cfg.tracking
    tmpl = template_j(trk.seq_len, det.detections_per_image,
                      trk.max_frame_dist)
    img = jnp.zeros((1, det.pad_height, det.pad_width, 3))
    det_params = random_params(MaskRCNNJ(det), img, seed=0,
                               method=MaskRCNNJ.predict)
    n_nodes = trk.seq_len * det.detections_per_image
    e2 = 2 * len(tmpl.src_frame)
    trk_params = random_params(
        TrackerJ(cfg.graph), jnp.zeros((n_nodes, 32, 32, 32)),
        jnp.zeros(e2, jnp.int32), jnp.zeros(e2, jnp.int32),
        jnp.zeros((e2, cfg.graph.edge_in_dim)), jnp.zeros(e2, bool), seed=1)
    # Two edits keep the comparison about the pipeline, not about rounding:
    # - random init leaves a quarter of the mask probabilities within 0.01
    #   of the 0.5 extraction threshold, where float32 and float64 decide
    #   different point sets: sharpen the mask predictor;
    # - random NOCS make every Umeyama fit ill-conditioned (a near-degenerate
    #   top eigenvalue, so the rotation moves by ~1e-3 under rounding): a
    #   constant NOCS head makes each fit the well-posed centroid of its
    #   kept depth points.  Well-posed rotations are pinned by
    #   test_torch_port_pose.py.
    det_params["params"]["mask_head"]["Conv_4"]["kernel"] *= 5.0
    det_params["params"]["nocs_head"]["ConvTranspose_3"]["kernel"] *= 0.0
    if import_mode:
        tame_affine_backbone(randomise_affine(det_params["params"],
                                              np.random.default_rng(2)))
        # The random tracker's edge logits differ by ~1e-3 only; spread
        # them, so a threshold separates the edges with a clear margin.
        trk_params["params"]["edge_classifier"]["Dense_1"]["kernel"] *= 300.0
    return det_params, trk_params


def _run_both(cfg, det_params, trk_params, arrays, key):
    """The JAX step and the port's on the same inputs, weights and draws:
    (JAX SequenceOutputs on the host, the port's SequenceOutputs)."""
    det, trk = cfg.detection, cfg.tracking

    with jax.enable_x64(True):
        f64 = functools.partial(jax.tree_util.tree_map,
                                lambda a: np.asarray(a, np.float64))
        step = step_j(MaskRCNNJ(det), TrackerJ(cfg.graph),
                      template_j(trk.seq_len, det.detections_per_image,
                                 trk.max_frame_dist), cfg)
        want = jit_run(step, f64(det_params), f64(trk_params), BatchJ(
            **{k: jnp.asarray(v) for k, v in arrays.items()},
            keys=key[None]))
        want = jax.device_get(want)
        draws = sequence_draws(key, trk.seq_len, det.detections_per_image,
                               cfg.pose.ransac_iters,
                               cfg.pose.ransac_sample_size)[None]

    cfg_t = port_config(cfg)
    det_t = MaskRCNNT(cfg_t.detection, device="cpu")
    det_t.load_state_dict(mask_rcnn_state_dict(det_params, cfg_t))
    trk_t = TrackerT(cfg_t.graph, device="cpu")
    trk_t.load_state_dict(tracker_state_dict(trk_params, cfg_t))
    step_t = make_sequence_infer_step(
        det_t.double(), trk_t.double(),
        make_template(trk.seq_len, det.detections_per_image,
                      trk.max_frame_dist), cfg_t, device="cpu")
    return want, step_t(BatchT(**arrays), draws=torch.from_numpy(draws))


def _assert_same_outputs(got, want):
    assert want.valid.sum() >= 4 and (want.obj_ids >= 0).sum() >= 4
    for name in ("obj_ids", "valid", "classes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("translations", "scores", "edge_probs"):
        a = np.asarray(getattr(want, name))
        b = getattr(got, name).numpy()
        assert np.isfinite(b).all(), name
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4, err_msg=name)
    assert ((got.edge_probs >= 0) & (got.edge_probs <= 1)).all()


@pytest.mark.parametrize("seed", [0])
def test_sequence_inference_matches_jax(seed):
    cfg = _open_gates(_tiny_config())
    want, got = _run_both(cfg, *_weights(), _batch(cfg, seed),
                          jax.random.PRNGKey(7 + seed))
    _assert_same_outputs(got, want)


def test_evaluation_path_matches_jax():
    """Import-mode detector with exact NMS -> pose -> graph -> MPN -> host
    assembly -> MOTA, on both sides."""
    cfg = _open_gates(_import_mode(_tiny_config()))
    det, trk = cfg.detection, cfg.tracking
    assert det.norm == "affine" and det.stride_in_1x1 and not det.fast_nms
    arrays = _batch(cfg, 1)
    want, got = _run_both(cfg, *_weights(True), arrays,
                          jax.random.PRNGKey(8))
    _assert_same_outputs(got, want)

    got = outputs_to_host(got)
    for a, b in zip(got, (want.edge_probs, want.obj_ids, want.valid,
                          want.translations, want.classes, want.scores)):
        assert isinstance(a, np.ndarray) and a.shape == b.shape

    # The edge threshold sits in the widest gap of the probabilities, so
    # the random tracker's edges split into positives and negatives, the
    # same ones on both sides.
    probs = np.sort(np.asarray(want.edge_probs[0], np.float64))
    gap = int(np.argmax(np.diff(probs)))
    thresh = float(probs[gap] + probs[gap + 1]) / 2
    assert probs[gap + 1] - probs[gap] > 2e-3
    trk = dataclasses.replace(trk, edge_threshold=thresh)
    args = (trk.seq_len, det.detections_per_image, trk.max_frame_dist)
    locations = arrays["gt_boxes3d"][0].mean(-2)
    results = []
    for tracker, tmpl, out in (
            (TrackerHostJ(trk), template_j(*args), want),
            (TrackerHostT(port_config(cfg.replace(tracking=trk)).tracking),
             make_template(*args), got)):
        e = len(tmpl.src_frame)
        pred = tracker.assemble(
            tmpl, np.asarray(out.edge_probs[0])[:e],
            *(np.asarray(x[0]) for x in (out.obj_ids, out.valid,
                                         out.translations, out.classes)))
        gt = tracker.gt_trajectories(
            arrays["gt_ids"][0], arrays["gt_valid"][0], locations,
            np.zeros(arrays["gt_ids"][0].shape, np.int64))
        results.append((pred, tracker.evaluate(pred, gt)))
    (pred_j, sum_j), (pred_t, sum_t) = results
    assert len(pred_t) == len(pred_j) >= 1
    for a, b in zip(pred_t, pred_j):
        assert [(d["scan_idx"], d["obj_idx"], d["cls"]) for d in a] == \
            [(d["scan_idx"], d["obj_idx"], d["cls"]) for d in b]
        np.testing.assert_allclose([d["loc"] for d in a],
                                   [d["loc"] for d in b], rtol=1e-4,
                                   atol=1e-4)
    assert sum_t.keys() == sum_j.keys()
    for key in sum_j:
        assert abs(sum_t[key] - sum_j[key]) <= 1e-12, key
