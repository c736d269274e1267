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
                                                   mask_rcnn_state_dict)
from mot3d_tpu_torch.importers.torch_ckpt import import_config
from mot3d_tpu_torch.models import nocs_head as nocs_t
from mot3d_tpu_torch.models import norms as norms_t
from mot3d_tpu_torch.models import resnet_fpn as resnet_t
from mot3d_tpu_torch.models import rpn as rpn_t
from mot3d_tpu_torch.models import voxel_head as voxel_t
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN as MaskRCNNT
from mot3d_tpu_torch.models.mask_rcnn import STRIDES
from mot3d_tpu_torch.ops import nms as nms_t
from mot3d_tpu_torch.ops.roi_align import multilevel_roi_align_packed as roi_t
from torch_port_helpers import (jit_run, port_config, random_params,
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
    if mode == "import_bins":
        # The import-mode weights with a bin head in place of the NOCS
        # regression head (random params of the head alone: tracing the
        # whole detector again would only rebuild the same shapes).
        params = jax.tree_util.tree_map(np.asarray, _models("import")[2])
        params = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                        params)
        params["params"]["nocs_head"] = randomise_affine(random_params(
            nocs_j.NocsBinDecoder(cfg_j.detection.nocs_num_bins,
                                  norm="affine"),
            jnp.zeros((1, 14, 14, cfg_j.detection.fpn_channels)), seed=7),
            rng)["params"]
    else:
        params = random_params(det_j, jnp.asarray(images),
                               method=MaskRCNNJ.predict)
    if mode == "import":
        tame_affine_backbone(randomise_affine(params["params"], rng))
    cfg_t = port_config(cfg_j)
    det_t = MaskRCNNT(cfg_t.detection, device="cpu").eval()
    det_t.load_state_dict(mask_rcnn_state_dict(params, cfg_t), strict=True)
    params64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      params)
    return cfg_j, det_j, params64, det_t.double(), images.astype(np.float64)


@functools.lru_cache(maxsize=1)
def _jax_gn():
    """JAX's FPN features, RPN head outputs and `predict` outputs of the
    "gn" model, from one program compiled and run once (under x64) for the
    tests that start from them."""
    cfg_j, det_j, params, det_t, images = _models()

    def run(m, x):
        feats = m.backbone(m._normalise(x))
        return feats, m.rpn_head(feats), m.predict(x)

    return jit_run(lambda p, x: det_j.apply(p, x, method=run), params,
                   jnp.asarray(images))


def _jax_rpn():
    """(FPN features, RPN head outputs) of `_jax_gn`."""
    return _jax_gn()[:2]


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def test_backbone_fpn_and_rpn_head():
    cfg_j, det_j, params, det_t, images = _models()
    feats_j, (obj_j, del_j) = _jax_rpn()
    with torch.no_grad():
        feats_t = det_t.features(to_torch(images))
        obj_t, del_t = det_t.rpn_head(feats_t)
    assert len(feats_t) == 5
    for lvl, (fj, ft) in enumerate(zip(feats_j, feats_t)):
        np.testing.assert_allclose(ft.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(fj), err_msg=f"P{lvl + 2}",
                                   **TOL)
    np.testing.assert_allclose(obj_t.numpy(), np.asarray(obj_j), **TOL)
    np.testing.assert_allclose(del_t.numpy(), np.asarray(del_j), **TOL)


@pytest.mark.parametrize("exact", [False, True])
def test_select_proposals_and_nms(exact):
    """The proposal chain on the same RPN outputs: top-k order (stable ties),
    decode, clip and level-aware NMS, fast and exact."""
    cfg_j, det_j, params, det_t, images = _models()
    c = cfg_j.detection
    _, (obj, dels) = _jax_rpn()
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
    feats_j, _ = _jax_rpn()
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
    want = jit_run(module_j.apply, jax.tree_util.tree_map(
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
    want = _jax_gn()[2] if mode == "gn" else jit_run(
        lambda p, x: det_j.apply(p, x, method=MaskRCNNJ.predict),
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
    """Every compute dtype and norm the JAX package takes builds (bf16 with
    float32 parameters); unknown values raise ValueError."""
    cfg = port_config(_tiny_config()).detection
    bf16 = MaskRCNNT(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                     device="cpu")
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert bf16.backbone.dtype == bf16.box_head.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        MaskRCNNT(dataclasses.replace(cfg, compute_dtype="float16"),
                  device="cpu")
    with pytest.raises(ValueError, match="unknown norm"):
        MaskRCNNT(dataclasses.replace(cfg, norm="batch"), device="cpu")


# ---------------------------------------------------------------- bf16
#
# detection.compute_dtype="bfloat16": parameters stay float32 and each
# layer computes in bfloat16 (flax's `dtype=`), GroupNorm statistics in
# float32.  One head is a few bf16 roundings (2^-8 relative each) from the
# same computation in JAX: its outputs agree within 2e-2 relative (L2;
# 2e-3 to 8e-3 measured).  Through R50-FPN's 53 random layers the
# rounding errors grow instead: JAX's own bf16 features sit 0.11-0.17
# (relative L2) from its float32 ones on these weights, the port's
# 0.14-0.19, and the two bf16 runs 0.13-0.19 from each other; each of the
# three distances must stay within 0.3.

BF16_HEAD_RTOL = 2e-2
BF16_FEATURE_RTOL = 0.3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_heads(c):
    """(flax head, port head) pairs at bfloat16 for the tiny config."""
    from mot3d_tpu.models import mask_rcnn as mrcnn_j
    from mot3d_tpu_torch.models import mask_rcnn as mrcnn_t
    j16, t16 = jnp.bfloat16, torch.bfloat16
    ch, r = c.fpn_channels, c.box_pooler_resolution
    return {
        "box": (mrcnn_j.BoxHead(c.num_classes, c.box_head_width, j16),
                mrcnn_t.BoxHead(ch, r, c.num_classes, c.box_head_width,
                                t16), r),
        "mask": (mrcnn_j.MaskHead(c.num_classes, c.mask_head_width, j16),
                 mrcnn_t.MaskHead(ch, c.num_classes, c.mask_head_width, t16),
                 14),
        "voxel": (voxel_j.Pix2VoxDecoder(c.head_width_mult, j16),
                  voxel_t.Pix2VoxDecoder(ch, 14, c.head_width_mult,
                                         dtype=t16), 14),
        "nocs": (nocs_j.NocsDecoder(j16), nocs_t.NocsDecoder(ch, dtype=t16),
                 14),
        "nocs_bins": (nocs_j.NocsBinDecoder(8, j16),
                      nocs_t.NocsBinDecoder(ch, 8, dtype=t16), 14),
    }


@pytest.mark.parametrize("head", ["box", "mask", "voxel", "nocs",
                                  "nocs_bins"])
def test_bf16_heads_match_jax(head):
    c = _tiny_config().detection
    module_j, module_t, r = _bf16_heads(c)[head]
    x = np.random.default_rng(9).normal(
        size=(3, r, r, c.fpn_channels)).astype(np.float32)
    params = random_params(module_j, jnp.asarray(x), seed=10)
    module_t.load_state_dict(flax_to_state_dict(params), strict=True)
    want = jax.tree_util.tree_leaves(
        jit_run(module_j.apply, params, jnp.asarray(x)))
    with torch.no_grad():
        got = module_t.eval()(to_torch(x))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert _rel(g.numpy(), w) <= BF16_HEAD_RTOL, head
    assert all(p.dtype == torch.float32 for p in module_t.parameters())


def test_bf16_detector_near_jax_and_float32():
    """The tiny gn detector at bfloat16 from the float32 weights: FPN
    features against JAX's at bfloat16 and both against float32 (the
    float64 run of `_jax_rpn`, rounded to float32 by the flax model);
    `predict` runs with float32 outputs and finds detections; the bf16
    model's state_dict is the float32 one."""
    cfg_j, det_j, params64, det_t64, images = _models()
    feats_f32, _ = _jax_rpn()
    c16 = dataclasses.replace(cfg_j.detection, compute_dtype="bfloat16")
    det_j16 = MaskRCNNJ(c16)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params64)
    img = jnp.asarray(images, jnp.float32)
    feats_j16 = jit_run(lambda p, x: det_j16.apply(
        p, x, method=lambda m, x: m.backbone(m._normalise(x))), params, img)
    cfg_t = port_config(cfg_j)
    det_t16 = MaskRCNNT(dataclasses.replace(cfg_t.detection,
                                            compute_dtype="bfloat16"),
                        device="cpu").eval()
    sd = mask_rcnn_state_dict(params, cfg_t)
    det_t16.load_state_dict(sd, strict=True)
    assert all(v.dtype == sd[k].dtype == torch.float32
               for k, v in det_t16.state_dict().items() if k in sd)
    with torch.no_grad():
        feats_t16 = det_t16.features(to_torch(np.asarray(img)))
    for lvl, (ft, fj, f32) in enumerate(zip(feats_t16, feats_j16,
                                             feats_f32)):
        assert ft.dtype == torch.float32 and fj.dtype == jnp.float32
        ft = ft.permute(0, 2, 3, 1).numpy()
        assert _rel(fj, f32) <= BF16_FEATURE_RTOL, f"JAX P{lvl + 2}"
        assert _rel(ft, f32) <= BF16_FEATURE_RTOL, f"port P{lvl + 2}"
        assert _rel(ft, fj) <= BF16_FEATURE_RTOL, f"port vs JAX P{lvl + 2}"
    dets = det_t16.predict(to_torch(np.asarray(img)))
    assert dets.valid.any()
    for name in ("boxes", "scores", "masks", "voxels", "nocs"):
        t = getattr(dets, name)
        assert t.dtype == torch.float32 and torch.isfinite(t).all(), name
