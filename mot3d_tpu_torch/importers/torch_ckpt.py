"""The reference's torch checkpoints -> the port's `state_dict`s
(counterpart of `mot3d_tpu/importers/torch_ckpt.py`).

The reference's protocol starts from torch weights: the detector
initialises from the COCO model zoo and trains to a `best_model.pth` that
every inference entry point reads (`Detection/cfg_setup.py:21,137`), and the
tracking stack loads one `.pth` per module ({voxel_encoder, graph_net,
edge_classifier}.pth, `Tracking/mpn_trainer.py:933-960`).

  - `import_detectron2_maskrcnn`: a detectron2-format GeneralizedRCNN
    state_dict (backbone.bottom_up, FPN, RPN, ROI heads and the reference's
    voxel and NOCS heads) -> the state_dict of
    `MaskRCNN(import_config(cfg))`.  Sections missing from the checkpoint
    (a COCO zoo detector has no voxel or NOCS head) keep a fresh model's
    weights when the import is partial.
  - `import_tracking_modules`: the three tracking state_dicts -> the
    state_dict of `TrackerModel(cfg)`, time-aware message passing included.

The reference's weights are already in torch layout, and the port's
modules are torch modules with the flax submodule names, so most tensors
only change their names.  Three rules change values or layout:
  - BatchNorm / FrozenBatchNorm (gamma, beta, mean, var) fold into the
    port's frozen affine: weight = gamma / sqrt(var + eps), bias = beta -
    mean * weight (numpy float32, as the JAX importer computes them);
  - a Linear after a flatten (the box head's fc1, the voxel encoder's fc)
    reads its input channels-last in the port, so its input axis is
    permuted from torch's channel-major (C, ...) order;
  - the voxel head's transposed convolutions are bias-free in torch; the
    port's have a bias, which is zero.

detectron2 places anchors at offset 0 and the stage stride on the
bottleneck's 1x1 convolution, so an imported detector runs under
`import_config`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import DetectionConfig, GraphConfig

_BN_EPS = 1e-5
_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def import_config(cfg: DetectionConfig) -> DetectionConfig:
    """The DetectionConfig variant a detectron2 checkpoint was trained
    under: frozen-affine norms, the torch `view()` voxel reshape,
    detectron2's anchor offset 0.0 and the stage stride on the bottleneck's
    1x1 convolution (RESNETS.STRIDE_IN_1X1)."""
    return dataclasses.replace(cfg, norm="affine", voxel_torch_reshape=True,
                               anchor_offset=0.0, stride_in_1x1=True)


def _np(t) -> np.ndarray:
    """torch.Tensor | np.ndarray -> a float32 C-ordered numpy copy (a copy
    also drops the negative strides a flipped size-1 axis can carry)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.array(t, np.float32, order="C", copy=True)


def linear_after_flatten(w, torch_shape) -> np.ndarray:
    """A torch Linear weight (O, C * prod(spatial)) over a channel-major
    flatten -> (O, prod(spatial) * C) over the port's channels-last one.
    torch_shape is the un-flattened input, e.g. (256, 7, 7)."""
    w = _np(w)
    out = w.shape[0]
    w = w.reshape((out,) + tuple(torch_shape))
    w = np.transpose(w, (0,) + tuple(range(2, w.ndim)) + (1,))
    return w.reshape(out, -1)


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """Load a .pth checkpoint (tensors only); unwrap detectron2's
    {"model": ...} envelope."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return dict(obj)


class _Consumer:
    """A state_dict that records which keys were read, so an import can
    report the keys it left unconsumed, and names a missing key."""

    def __init__(self, sd: Mapping[str, Any], what: str = "checkpoint"):
        self.sd = dict(sd)
        self.what = what
        self.used: set = set()

    def __contains__(self, key):
        return key in self.sd

    def get(self, key) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"{self.what} is missing key {key!r}")
        self.used.add(key)
        return _np(self.sd[key])

    def affine(self, prefix) -> Dict[str, np.ndarray]:
        gamma, beta, mean, var = (self.get(f"{prefix}.{s}") for s in (
            "weight", "bias", "running_mean", "running_var"))
        scale = gamma / np.sqrt(var + _BN_EPS)
        return {"weight": scale, "bias": beta - mean * scale}

    def layer(self, prefix, bias=True) -> Dict[str, np.ndarray]:
        """A Conv, ConvTranspose or Linear: torch layout as it is."""
        out = {"weight": self.get(f"{prefix}.weight")}
        if bias:
            out["bias"] = self.get(f"{prefix}.bias")
        return out

    def leftover(self):
        return sorted(k for k in self.sd if k not in self.used
                      and not k.endswith(".num_batches_tracked"))


def _flat(tree: Mapping[str, Any], prefix: str = ""):
    """{module: {... {param: array}}} -> {"module.param": array}."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flat(val, name + "."))
        else:
            out[name] = val
    return out


# ------------------------------------------------------------- detector


def _backbone(c: _Consumer, cfg: DetectionConfig) -> dict:
    p = "backbone.bottom_up"
    resnet: Dict[str, Any] = {
        "stem": {"weight": c.get(f"{p}.stem.conv1.weight")},
        "stem_gn": c.affine(f"{p}.stem.conv1.norm")}
    for stage, n_blocks in enumerate(_BLOCKS[cfg.backbone_depth]):
        for b in range(n_blocks):
            q = f"{p}.res{stage + 2}.{b}"
            blk: Dict[str, Any] = {}
            for i in range(3):
                blk[f"Conv_{i}"] = c.layer(f"{q}.conv{i + 1}", bias=False)
                blk[f"AffineChannelNorm_{i}"] = c.affine(
                    f"{q}.conv{i + 1}.norm")
            if f"{q}.shortcut.weight" in c:
                blk["proj"] = c.layer(f"{q}.shortcut", bias=False)
                blk["proj_gn"] = c.affine(f"{q}.shortcut.norm")
            resnet[f"res{stage + 2}_{b}"] = blk
    fpn = {}
    for i in range(2, 6):
        fpn[f"lat{i}"] = c.layer(f"backbone.fpn_lateral{i}")
        fpn[f"post{i}"] = c.layer(f"backbone.fpn_output{i}")
    return {"resnet": resnet, "fpn": fpn}


def _rpn(c: _Consumer, cfg: DetectionConfig) -> dict:
    p = "proposal_generator.rpn_head"
    return {"conv": c.layer(f"{p}.conv"),
            "objectness": c.layer(f"{p}.objectness_logits"),
            "deltas": c.layer(f"{p}.anchor_deltas")}


def _box_head(c: _Consumer, cfg: DetectionConfig) -> dict:
    r, ch = cfg.box_pooler_resolution, cfg.fpn_channels
    return {"fc1": {"weight": linear_after_flatten(
                        c.get("roi_heads.box_head.fc1.weight"), (ch, r, r)),
                    "bias": c.get("roi_heads.box_head.fc1.bias")},
            "Dense_0": c.layer("roi_heads.box_head.fc2"),
            "cls": c.layer("roi_heads.box_predictor.cls_score"),
            "box": c.layer("roi_heads.box_predictor.bbox_pred")}


def _mask_head(c: _Consumer, cfg: DetectionConfig) -> dict:
    p = "roi_heads.mask_head"
    out = {f"Conv_{i}": c.layer(f"{p}.mask_fcn{i + 1}") for i in range(4)}
    out["ConvTranspose_0"] = c.layer(f"{p}.deconv")
    out["Conv_4"] = c.layer(f"{p}.predictor")
    return out


def _voxel_head(c: _Consumer, cfg: DetectionConfig) -> dict:
    p = "roi_heads.voxel_head.decoder"
    out: Dict[str, Any] = {}
    for i, width in enumerate((512, 128, 32, 8, 1)):
        out[f"ConvTranspose_{i}"] = {
            "weight": c.get(f"{p}.layer{i + 1}.0.weight"),
            "bias": np.zeros(width, np.float32)}
        if i < 4:                                   # layer5 has no BN
            out[f"AffineChannelNorm_{i}"] = c.affine(f"{p}.layer{i + 1}.1")
    return out


def _nocs_head(c: _Consumer, cfg: DetectionConfig) -> dict:
    p = "roi_heads.nocs_head.nocs_layers"
    out: Dict[str, Any] = {}
    if cfg.nocs_use_bin_loss:
        # Towers r, g, b are torch's R, G, B; two affines per tower, in
        # (layer1, layer2) order.
        for t, ch in enumerate("RGB"):
            lo = ch.lower()
            out[f"l1_{lo}"] = c.layer(f"{p}.layer1_{ch}.0")
            out[f"AffineChannelNorm_{2 * t}"] = c.affine(
                f"{p}.layer1_{ch}.2")
            out[f"l2_{lo}"] = c.layer(f"{p}.layer2_{ch}.0")
            out[f"AffineChannelNorm_{2 * t + 1}"] = c.affine(
                f"{p}.layer2_{ch}.2")
            out[f"l3_{lo}"] = c.layer(f"{p}.layer3_{ch}.0")
    else:
        for i in range(4):
            out[f"ConvTranspose_{i}"] = c.layer(f"{p}.layer{i}.0")
            if i < 3:                 # layer3 is ConvT + Sigmoid, no BN
                out[f"AffineChannelNorm_{i}"] = c.affine(f"{p}.layer{i}.2")
    return out


def _sections(cfg: DetectionConfig):
    """(port section, its importer, the detectron2 key that shows the
    section is in a checkpoint) for every section of `MaskRCNN(cfg)`."""
    secs = [("backbone", _backbone, "backbone.bottom_up.stem.conv1.weight"),
            ("rpn_head", _rpn, "proposal_generator.rpn_head.conv.weight"),
            ("box_head", _box_head, "roi_heads.box_head.fc1.weight"),
            ("mask_head", _mask_head, "roi_heads.mask_head.mask_fcn1.weight")]
    if cfg.voxel_on:
        secs.append(("voxel_head", _voxel_head,
                     "roi_heads.voxel_head.decoder.layer1.0.weight"))
    if cfg.nocs_on:
        secs.append(("nocs_head", _nocs_head,
                     "roi_heads.nocs_head.nocs_layers.layer1_R.0.weight"
                     if cfg.nocs_use_bin_loss
                     else "roi_heads.nocs_head.nocs_layers.layer0.0.weight"))
    return secs


def import_detectron2_maskrcnn(
        state_dict: Mapping[str, Any], cfg: DetectionConfig,
        init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        strict: bool = True) -> Dict[str, torch.Tensor]:
    """detectron2 GeneralizedRCNN(+VoxelNocsHeads) state_dict -> the
    state_dict of `MaskRCNN(cfg)`.

    cfg must be an `import_config` at full reference widths.  strict=True
    refuses a checkpoint that lacks a section or a key, or holds a key that
    no layer reads (apart from detectron2's anchor buffers and pixel
    statistics).  With strict=False a section absent from the checkpoint
    (the voxel and NOCS heads of a COCO zoo detector) takes its tensors
    from `init_state_dict`, a fresh `MaskRCNN(cfg).state_dict()`: the
    reference's model-zoo start (`Detection/cfg_setup.py:21`)."""
    if cfg.norm != "affine" or not cfg.voxel_torch_reshape:
        raise ValueError(
            "import requires cfg.norm='affine' and "
            "cfg.voxel_torch_reshape=True (torch-parity model structure)")
    if not cfg.stride_in_1x1 or cfg.anchor_offset != 0.0:
        raise ValueError(
            "import requires cfg.stride_in_1x1=True and cfg.anchor_offset="
            "0.0 (use importers.torch_ckpt.import_config): detectron2 "
            "weights compute a different function under the torchvision "
            "stride placement / 0.5 anchor offset")
    if (cfg.backbone_width != 1.0 or cfg.head_width_mult != 1.0
            or cfg.fpn_channels != 256):
        raise ValueError("import only supports full reference widths")
    c = _Consumer(state_dict)
    out: Dict[str, torch.Tensor] = {}
    for name, fn, probe in _sections(cfg):
        if probe in c:
            out.update({f"{name}.{k}": torch.from_numpy(
                np.ascontiguousarray(v)) for k, v in _flat(fn(c, cfg)).items()})
            continue
        if strict:
            raise KeyError(f"checkpoint is missing section {name!r} (no "
                           f"{probe}); a partial import (--allow-partial) "
                           "keeps a fresh init for it")
        if init_state_dict is None:
            raise KeyError(f"section {name!r} is absent from the checkpoint "
                           "and no init_state_dict was given")
        out.update({k: v.detach().cpu().clone()
                    for k, v in init_state_dict.items()
                    if k.startswith(name + ".")})
    if strict:
        # Anchor buffers serialise under '...anchor_generator.cell_anchors'
        # in older detectron2 versions; pixel_mean/std are statistics.
        extra = [k for k in c.leftover()
                 if not (k.startswith("pixel_") or "anchor_generator." in k)]
        if extra:
            raise KeyError(f"unconsumed checkpoint keys: {extra[:8]}"
                           f"{' ...' if len(extra) > 8 else ''}")
    return out


# ------------------------------------------------------------- tracking

# The reference's MLP submodules (`Tracking/networks/mpn.py`) -> the port's.
TRACKING_MLPS = {"edge_encoder": "encoder.edge_mlp",
                 "edge_model": "MPNet.edge_model.edge_mlp",
                 "node_model": "MPNet.node_model.node_mlp",
                 "flow_in": "MPNet.node_model.flow_in_mlp",
                 "flow_out": "MPNet.node_model.flow_out_mlp",
                 "node_fuse": "MPNet.node_model.node_mlp"}
VOXEL_ENCODER_CONVS = ("conv_in", "conv_0", "conv_1", "conv_2")


def graph_net_mlps(cfg: GraphConfig):
    """The port's MLP submodules of `MPGraph(cfg)`, in order."""
    node = (("flow_in", "flow_out", "node_fuse") if cfg.time_aware_mp
            else ("node_model",))
    return ("edge_encoder", "edge_model") + node


def _mlp(c: _Consumer, prefix: str) -> dict:
    """The reference MLP (`Tracking/networks/mlp.py`) is a Sequential of
    Linear layers with activations (and dropout) between them: its Linear
    layers in ascending index are the port's Dense_0, Dense_1, ..."""
    idxs = sorted({int(k.split(".")[-2]) for k in c.sd
                   if k.startswith(f"{prefix}.layers.")
                   and k.endswith(".weight")})
    if not idxs:
        raise KeyError(f"{c.what} is missing the MLP {prefix!r}")
    return {f"Dense_{i}": c.layer(f"{prefix}.layers.{j}")
            for i, j in enumerate(idxs)}


def import_tracking_modules(voxel_encoder_sd: Mapping[str, Any],
                            graph_net_sd: Mapping[str, Any],
                            edge_classifier_sd: Mapping[str, Any],
                            cfg: GraphConfig) -> Dict[str, torch.Tensor]:
    """The reference's three tracking state_dicts (as saved by
    `Tracking/mpn_trainer.py:860-960`) -> the state_dict of
    `TrackerModel(cfg)`.  Every key of each must be consumed."""
    cv = _Consumer(voxel_encoder_sd, "voxel_encoder")
    venc = {f"Conv_{i}": cv.layer(name)
            for i, name in enumerate(VOXEL_ENCODER_CONVS)}
    # fc reads torch's channel-major (32, 4, 4, 4) flatten.
    venc["Dense_0"] = {"weight": linear_after_flatten(cv.get("fc.weight"),
                                                      (32, 4, 4, 4)),
                       "bias": cv.get("fc.bias")}
    venc["Dense_1"] = cv.layer("fc2")
    cg = _Consumer(graph_net_sd, "graph_net")
    gnet = {name: _mlp(cg, TRACKING_MLPS[name])
            for name in graph_net_mlps(cfg)}
    ce = _Consumer(edge_classifier_sd, "edge_classifier")
    eclf = {"Dense_0": ce.layer("fc1"), "Dense_1": ce.layer("fc2")}
    for cons in (cv, cg, ce):
        extra = cons.leftover()
        if extra:
            raise KeyError(f"unconsumed {cons.what} keys: {extra}")
    tree = {"voxel_encoder": venc, "graph_net": gnet,
            "edge_classifier": eclf}
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _flat(tree).items()}
