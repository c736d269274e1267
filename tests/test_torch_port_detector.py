"""Parity of the port's detector (mot3d_tpu_torch.models.mask_rcnn and the
modules under it) against the JAX package at the tiny config, with the
flax parameters carried across by `importers/flax_params.py`, on the CPU.

Each stage is compared on its own inputs, so a fault points at its module.
Both frameworks compute in float64 here (JAX under `jax.enable_x64`, the
port after `.double()`): in float32 the 53 convolutions and GroupNorms of
R50-FPN, summed in another order by XLA and by torch, drift apart by up to
~5e-4 at P2, which would hide a semantic fault of that size and flip
near-tied proposal rankings.  The JAX model still rounds its backbone,
RPN and head outputs to float32, so the outputs agree to ~1e-6.
Tolerances: continuous outputs rtol 1e-4 / atol 1e-4; discrete outputs
(proposal order, classes, validity) exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mot3d_tpu.models import rpn as rpn_j
from mot3d_tpu.models.mask_rcnn import MaskRCNN as MaskRCNNJ
from mot3d_tpu.models.mask_rcnn import RPN_STRIDES
from mot3d_tpu.ops import nms as nms_j
from mot3d_tpu.ops.roi_align import multilevel_roi_align_packed as roi_j
from mot3d_tpu_torch.importers.flax_params import mask_rcnn_state_dict
from mot3d_tpu_torch.models import rpn as rpn_t
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN as MaskRCNNT
from mot3d_tpu_torch.models.mask_rcnn import STRIDES
from mot3d_tpu_torch.ops import nms as nms_t
from mot3d_tpu_torch.ops.roi_align import multilevel_roi_align_packed as roi_t
from torch_port_helpers import port_config, random_params, to_torch

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=1)
def _models():
    cfg_j = _tiny_config()
    det_j = MaskRCNNJ(cfg_j.detection)
    rng = np.random.default_rng(0)
    h, w = cfg_j.detection.pad_height, cfg_j.detection.pad_width
    images = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    params = random_params(det_j, jnp.asarray(images),
                           method=MaskRCNNJ.predict)
    cfg_t = port_config(cfg_j)
    det_t = MaskRCNNT(cfg_t.detection, device="cpu").eval()
    det_t.load_state_dict(mask_rcnn_state_dict(params, cfg_t), strict=True)
    params64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      params)
    return cfg_j, det_j, params64, det_t.double(), images.astype(np.float64)


def _jax_features(det_j, params, images):
    return jax.jit(lambda p, x: det_j.apply(
        p, x, method=lambda m, x: m.backbone(m._normalise(x))))(
        params, jnp.asarray(images))


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def test_backbone_fpn_and_rpn_head():
    cfg_j, det_j, params, det_t, images = _models()
    feats_j = _jax_features(det_j, params, images)
    with torch.no_grad():
        feats_t = det_t.features(to_torch(images))
        obj_t, del_t = det_t.rpn_head(feats_t)
    assert len(feats_t) == 5
    for lvl, (fj, ft) in enumerate(zip(feats_j, feats_t)):
        np.testing.assert_allclose(ft.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(fj), err_msg=f"P{lvl + 2}",
                                   **TOL)
    obj_j, del_j = jax.jit(lambda p, f: det_j.apply(
        p, f, method=lambda m, f: m.rpn_head(f)))(params, feats_j)
    np.testing.assert_allclose(obj_t.numpy(), np.asarray(obj_j), **TOL)
    np.testing.assert_allclose(del_t.numpy(), np.asarray(del_j), **TOL)


@pytest.mark.parametrize("exact", [False, True])
def test_select_proposals_and_nms(exact):
    """The proposal chain on the same RPN outputs: top-k order (stable ties),
    decode, clip and level-aware NMS, fast and exact."""
    cfg_j, det_j, params, det_t, images = _models()
    c = cfg_j.detection
    feats_j = _jax_features(det_j, params, images)
    obj, dels = jax.jit(lambda p, f: det_j.apply(
        p, f, method=lambda m, f: m.rpn_head(f)))(params, feats_j)
    anchors = rpn_j.generate_anchors(c.pad_height, c.pad_width,
                                     tuple(c.anchor_sizes),
                                     tuple(c.anchor_ratios), RPN_STRIDES,
                                     c.anchor_offset)
    slices = rpn_j.level_slices(c.pad_height, c.pad_width,
                                len(c.anchor_ratios), RPN_STRIDES)
    args = ((c.pad_height, c.pad_width), c.rpn_pre_nms_topk_test,
            c.rpn_post_nms_topk_test, c.rpn_nms_thresh, exact)
    got = rpn_t.select_proposals(to_torch(anchors).double(), to_torch(obj),
                                 to_torch(dels), slices, *args)
    select_j = jax.jit(lambda o, d: rpn_j.select_proposals(
        jnp.asarray(anchors), o, d, slices, *args))
    for i in range(images.shape[0]):
        want = select_j(obj[i], dels[i])
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        v = np.asarray(want[2])
        np.testing.assert_allclose(got[0][i].numpy()[v],
                                   np.asarray(want[0])[v], **TOL)
        np.testing.assert_allclose(got[1][i].numpy()[v],
                                   np.asarray(want[1])[v], **TOL)


def test_nms_and_top_k_ties():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 100, (64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (64, 2))], 1
                           ).astype(np.float32)
    scores = np.round(rng.uniform(size=64), 1).astype(np.float32)  # ties
    valid = np.ones(64, bool)
    valid[5] = False
    for exact in (False, True):
        np.testing.assert_array_equal(
            nms_t.nms_mask(*map(to_torch, (boxes, scores, valid)), 0.5,
                           exact).numpy(),
            np.asarray(nms_j.nms_mask(*map(jnp.asarray, (boxes, scores,
                                                         valid)), 0.5,
                                      exact)))
    idx_t, ok_t = nms_t.top_k_by_score(to_torch(scores), to_torch(valid), 20)
    idx_j, ok_j = nms_j.top_k_by_score(jnp.asarray(scores),
                                       jnp.asarray(valid), 20)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


def test_roi_align_packed():
    cfg_j, det_j, params, det_t, images = _models()
    feats_j = _jax_features(det_j, params, images)
    rng = np.random.default_rng(4)
    xy = rng.uniform(-4, 60, (9, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 64, (9, 2))], 1)
    want = roi_j([f[0] for f in feats_j[:4]], jnp.asarray(boxes), 7, STRIDES)
    got = roi_t([to_torch(f[0]).permute(2, 0, 1) for f in feats_j[:4]],
                to_torch(boxes), 7, STRIDES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_predict():
    cfg_j, det_j, params, det_t, images = _models()
    want = jax.jit(lambda p, x: det_j.apply(p, x, method=MaskRCNNJ.predict))(
        params, jnp.asarray(images))
    got = det_t.predict(to_torch(images))
    ok = np.asarray(want.valid)
    assert ok.any()
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    for name in ("boxes", "scores", "masks", "voxels", "nocs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)


def test_unported_detector_options_raise():
    cfg = port_config(_tiny_config()).detection
    import dataclasses
    for field in ("stride_in_1x1", "voxel_torch_reshape",
                  "nocs_use_bin_loss"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MaskRCNNT(dataclasses.replace(cfg, **{field: True}),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MaskRCNNT(dataclasses.replace(cfg, norm="affine"), device="cpu")
