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

The import-mode cases (`import_config`: affine norms, stride on the 1x1,
torch voxel reshape, anchor offset 0; exact NMS; NOCS bins) carry random,
non-trivial affine scales and biases across, so a norm applied on the wrong
side of the ReLU or a wrongly laid-out tower kernel shows.
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
from mot3d_tpu.models import nocs_head as nocs_j
from mot3d_tpu.models import norms as norms_j
from mot3d_tpu.models import resnet_fpn as resnet_j
from mot3d_tpu.models import rpn as rpn_j
from mot3d_tpu.models import voxel_head as voxel_j
from mot3d_tpu.models.mask_rcnn import MaskRCNN as MaskRCNNJ
from mot3d_tpu.models.mask_rcnn import RPN_STRIDES
from mot3d_tpu.ops import nms as nms_j
from mot3d_tpu.ops.roi_align import multilevel_roi_align_packed as roi_j
from mot3d_tpu_torch.importers.flax_params import (flax_to_state_dict,
                                                   import_config,
                                                   mask_rcnn_state_dict)
from mot3d_tpu_torch.models import nocs_head as nocs_t
from mot3d_tpu_torch.models import norms as norms_t
from mot3d_tpu_torch.models import resnet_fpn as resnet_t
from mot3d_tpu_torch.models import rpn as rpn_t
from mot3d_tpu_torch.models import voxel_head as voxel_t
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN as MaskRCNNT
from mot3d_tpu_torch.models.mask_rcnn import STRIDES
from mot3d_tpu_torch.ops import nms as nms_t
from mot3d_tpu_torch.ops.roi_align import multilevel_roi_align_packed as roi_t
from torch_port_helpers import (port_config, random_params,
                                randomise_affine, tame_affine_backbone,
                                to_torch)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _import_mode(cfg_j, bins):
    """The tiny config as an imported reference detector is evaluated:
    `import_config` and exact NMS, with or without the NOCS bin head."""
    return cfg_j.replace(detection=dataclasses.replace(
        import_config_j(cfg_j.detection), fast_nms=False,
        nocs_use_bin_loss=bins))


@functools.lru_cache(maxsize=3)
def _models(mode="gn"):
    cfg_j = _tiny_config()
    if mode != "gn":
        cfg_j = _import_mode(cfg_j, bins=mode == "import_bins")
    det_j = MaskRCNNJ(cfg_j.detection)
    rng = np.random.default_rng(0)
    h, w = cfg_j.detection.pad_height, cfg_j.detection.pad_width
    images = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    params = random_params(det_j, jnp.asarray(images),
                           method=MaskRCNNJ.predict)
    if mode != "gn":
        tame_affine_backbone(randomise_affine(params["params"], rng))
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


def _sub_module(module_j, module_t, x, seed=0):
    """Random params for a flax sub-module (affine parts non-trivial),
    carried into its port counterpart; both in float64.  x is NHWC."""
    params = random_params(module_j, jnp.asarray(x, jnp.float32), seed=seed)
    randomise_affine(params["params"], np.random.default_rng(seed + 1))
    module_t.load_state_dict(flax_to_state_dict(params), strict=True)
    want = module_j.apply(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), params), jnp.asarray(x))
    return np.asarray(want), module_t.double().eval()


def _nchw(x):
    return to_torch(x).permute(0, 3, 1, 2)


def test_affine_channel_norm():
    x = np.random.default_rng(1).normal(size=(2, 5, 6, 8))
    want, mod = _sub_module(norms_j.AffineChannelNorm(),
                            norms_t.AffineChannelNorm(8), x)
    with torch.no_grad():
        got = mod(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert isinstance(norms_t.make_norm("affine", 32, 8),
                      norms_t.AffineChannelNorm)
    with pytest.raises(ValueError, match="unknown norm"):
        norms_t.make_norm("batch", 32, 8)


@pytest.mark.parametrize("norm,stride_in_1x1", [("affine", True),
                                                ("affine", False),
                                                ("gn", True)])
def test_bottleneck_stride_placement(norm, stride_in_1x1):
    """Odd input size, so the stride-2 1x1 and the stride-2 3x3 sample
    different pixels."""
    x = np.random.default_rng(2).normal(size=(2, 9, 11, 64))
    want, mod = _sub_module(
        resnet_j.Bottleneck(32, 2, norm=norm, stride_in_1x1=stride_in_1x1),
        resnet_t.Bottleneck(64, 32, 2, norm, stride_in_1x1), x)
    with torch.no_grad():
        got = mod(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("norm,torch_reshape", [("affine", True),
                                                ("gn", True),
                                                ("affine", False)])
def test_voxel_decoder_import_mode(norm, torch_reshape):
    x = np.random.default_rng(3).normal(size=(2, 14, 14, 32))
    want, mod = _sub_module(
        voxel_j.Pix2VoxDecoder(0.125, norm=norm, torch_reshape=torch_reshape),
        voxel_t.Pix2VoxDecoder(32, 14, 0.125, norm, torch_reshape), x)
    with torch.no_grad():
        got = mod(to_torch(x))
    assert got.shape == (2, 32, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_nocs_decoder_affine_after_relu():
    x = np.random.default_rng(4).normal(size=(2, 14, 14, 32))
    want, mod = _sub_module(nocs_j.NocsDecoder(norm="affine"),
                            nocs_t.NocsDecoder(32, "affine"), x)
    with torch.no_grad():
        got = mod(to_torch(x))
    assert got.shape == (2, 28, 28, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("norm", ["affine", "gn"])
def test_nocs_bin_decoder_and_bins_to_values(norm):
    x = np.random.default_rng(5).normal(size=(2, 14, 14, 32))
    want, mod = _sub_module(nocs_j.NocsBinDecoder(8, norm=norm),
                            nocs_t.NocsBinDecoder(32, 8, norm), x)
    with torch.no_grad():
        got = mod(to_torch(x))
    assert got.shape == (2, 28, 28, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # Values from the same logits (ties included: the first bin wins).
    logits = np.round(want, 1)
    assert (np.sort(logits, -1)[..., -1] == np.sort(logits, -1)[..., -2]).any()
    np.testing.assert_allclose(
        nocs_t.nocs_bins_to_values(to_torch(logits), 8).numpy(),
        np.asarray(nocs_j.nocs_bins_to_values(jnp.asarray(logits), 8)),
        rtol=1e-6, atol=1e-6)


def test_import_config_is_a_faithful_copy():
    cfg = _tiny_config()
    assert dataclasses.asdict(import_config(port_config(cfg).detection)) == \
        dataclasses.asdict(import_config_j(cfg.detection))


@pytest.mark.parametrize("mode", ["gn", "import", "import_bins"])
def test_predict(mode):
    cfg_j, det_j, params, det_t, images = _models(mode)
    assert cfg_j.detection.fast_nms == (mode == "gn")
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MaskRCNNT(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                  device="cpu")
    with pytest.raises(ValueError, match="unknown norm"):
        MaskRCNNT(dataclasses.replace(cfg, norm="batch"), device="cpu")
