"""The port's `state_dict`s -> the reference's torch checkpoints (the inverse
of `importers/torch_ckpt.py`; counterpart of
`mot3d_tpu/importers/torch_export.py`).

A detector or tracker trained with the port can be handed to the
reference's tooling, whose entry points read a detectron2-format
`best_model.pth` (`Detection/cfg_setup.py:137`) and the tracking stack's
three module files; and export -> import is the identity, which tests the
import tables without the reference's code.

Frozen affines export as FrozenBatchNorm with running_mean = 0 and
running_var = 1 - eps: detectron2's eval-time BatchNorm then computes the
affine's own scale and bias, and the importer folds them back to the same
float32 values (the JAX package's export does the same).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from mot3d_tpu_torch.config import DetectionConfig, GraphConfig
from mot3d_tpu_torch.importers.torch_ckpt import (_BLOCKS, _BN_EPS,
                                                  TRACKING_MLPS,
                                                  VOXEL_ENCODER_CONVS,
                                                  graph_net_mlps)

SECTIONS = ("backbone", "rpn_head", "box_head", "mask_head", "voxel_head",
            "nocs_head")


class _Writer:
    """Reads the port's state_dict by module path, writes detectron2
    names."""

    def __init__(self, sd: Mapping[str, torch.Tensor]):
        self.src = sd
        self.out: Dict[str, np.ndarray] = {}

    def arr(self, key) -> np.ndarray:
        return np.ascontiguousarray(
            self.src[key].detach().cpu().numpy().astype(np.float32))

    def layer(self, torch_prefix, port_prefix, bias=True):
        self.out[f"{torch_prefix}.weight"] = self.arr(f"{port_prefix}.weight")
        if bias:
            self.out[f"{torch_prefix}.bias"] = self.arr(f"{port_prefix}.bias")

    def affine(self, torch_prefix, port_prefix):
        scale = self.arr(f"{port_prefix}.weight")
        self.out[f"{torch_prefix}.weight"] = scale
        self.out[f"{torch_prefix}.bias"] = self.arr(f"{port_prefix}.bias")
        self.out[f"{torch_prefix}.running_mean"] = np.zeros_like(scale)
        self.out[f"{torch_prefix}.running_var"] = np.full_like(
            scale, 1.0 - _BN_EPS)

    def flattened(self, torch_key, port_key, torch_shape):
        """Inverse of `torch_ckpt.linear_after_flatten`."""
        w = self.arr(port_key)
        out, ch = w.shape[0], torch_shape[0]
        w = w.reshape((out,) + tuple(torch_shape[1:]) + (ch,))
        w = np.transpose(w, (0, w.ndim - 1) + tuple(range(1, w.ndim - 1)))
        self.out[torch_key] = np.ascontiguousarray(w.reshape(out, -1))


def export_detectron2_maskrcnn(state_dict: Mapping[str, torch.Tensor],
                               cfg: DetectionConfig,
                               sections: Tuple[str, ...] = SECTIONS
                               ) -> Dict[str, np.ndarray]:
    """The state_dict of `MaskRCNN(cfg)` (cfg an `import_config`) ->
    detectron2-format state_dict of float32 numpy arrays.  `sections`
    restricts the export: ("backbone",) makes a COCO-zoo-like
    backbone-only checkpoint for the partial import."""
    if cfg.norm != "affine" or not cfg.voxel_torch_reshape:
        raise ValueError("export requires cfg.norm='affine' and "
                         "cfg.voxel_torch_reshape=True (the torch-parity "
                         "model structure)")
    w = _Writer(state_dict)
    if "backbone" in sections:
        p, q = "backbone.bottom_up", "backbone.resnet"
        w.layer(f"{p}.stem.conv1", f"{q}.stem", bias=False)
        w.affine(f"{p}.stem.conv1.norm", f"{q}.stem_gn")
        for stage, n_blocks in enumerate(_BLOCKS[cfg.backbone_depth]):
            for b in range(n_blocks):
                tp, pp = f"{p}.res{stage + 2}.{b}", f"{q}.res{stage + 2}_{b}"
                for i in range(3):
                    w.layer(f"{tp}.conv{i + 1}", f"{pp}.Conv_{i}", bias=False)
                    w.affine(f"{tp}.conv{i + 1}.norm",
                             f"{pp}.AffineChannelNorm_{i}")
                if f"{pp}.proj.weight" in state_dict:
                    w.layer(f"{tp}.shortcut", f"{pp}.proj", bias=False)
                    w.affine(f"{tp}.shortcut.norm", f"{pp}.proj_gn")
        for i in range(2, 6):
            w.layer(f"backbone.fpn_lateral{i}", f"backbone.fpn.lat{i}")
            w.layer(f"backbone.fpn_output{i}", f"backbone.fpn.post{i}")
    if "rpn_head" in sections:
        p = "proposal_generator.rpn_head"
        w.layer(f"{p}.conv", "rpn_head.conv")
        w.layer(f"{p}.objectness_logits", "rpn_head.objectness")
        w.layer(f"{p}.anchor_deltas", "rpn_head.deltas")
    if "box_head" in sections:
        r, ch = cfg.box_pooler_resolution, cfg.fpn_channels
        w.flattened("roi_heads.box_head.fc1.weight", "box_head.fc1.weight",
                    (ch, r, r))
        w.out["roi_heads.box_head.fc1.bias"] = w.arr("box_head.fc1.bias")
        w.layer("roi_heads.box_head.fc2", "box_head.Dense_0")
        w.layer("roi_heads.box_predictor.cls_score", "box_head.cls")
        w.layer("roi_heads.box_predictor.bbox_pred", "box_head.box")
    if "mask_head" in sections:
        p = "roi_heads.mask_head"
        for i in range(4):
            w.layer(f"{p}.mask_fcn{i + 1}", f"mask_head.Conv_{i}")
        w.layer(f"{p}.deconv", "mask_head.ConvTranspose_0")
        w.layer(f"{p}.predictor", "mask_head.Conv_4")
    if "voxel_head" in sections and cfg.voxel_on:
        p = "roi_heads.voxel_head.decoder"
        for i in range(5):
            # Bias-free in torch; the importer restores the zero bias.
            w.layer(f"{p}.layer{i + 1}.0", f"voxel_head.ConvTranspose_{i}",
                    bias=False)
            if i < 4:
                w.affine(f"{p}.layer{i + 1}.1",
                         f"voxel_head.AffineChannelNorm_{i}")
    if "nocs_head" in sections and cfg.nocs_on:
        p = "roi_heads.nocs_head.nocs_layers"
        if cfg.nocs_use_bin_loss:
            for t, chn in enumerate("RGB"):
                lo = chn.lower()
                w.layer(f"{p}.layer1_{chn}.0", f"nocs_head.l1_{lo}")
                w.affine(f"{p}.layer1_{chn}.2",
                         f"nocs_head.AffineChannelNorm_{2 * t}")
                w.layer(f"{p}.layer2_{chn}.0", f"nocs_head.l2_{lo}")
                w.affine(f"{p}.layer2_{chn}.2",
                         f"nocs_head.AffineChannelNorm_{2 * t + 1}")
                w.layer(f"{p}.layer3_{chn}.0", f"nocs_head.l3_{lo}")
        else:
            for i in range(4):
                w.layer(f"{p}.layer{i}.0", f"nocs_head.ConvTranspose_{i}")
                if i < 3:
                    w.affine(f"{p}.layer{i}.2",
                             f"nocs_head.AffineChannelNorm_{i}")
    return w.out


def export_tracking_modules(state_dict: Mapping[str, torch.Tensor],
                            cfg: GraphConfig
                            ) -> Tuple[Dict[str, np.ndarray], ...]:
    """The state_dict of `TrackerModel(cfg)` -> the reference's
    (voxel_encoder, graph_net, edge_classifier) state_dicts.  The
    reference's MLPs interleave Linear layers with activations, so Dense_i
    is `layers.{2 i}`."""
    w = _Writer(state_dict)
    for i, name in enumerate(VOXEL_ENCODER_CONVS):
        w.layer(name, f"voxel_encoder.Conv_{i}")
    w.flattened("fc.weight", "voxel_encoder.Dense_0.weight", (32, 4, 4, 4))
    w.out["fc.bias"] = w.arr("voxel_encoder.Dense_0.bias")
    w.layer("fc2", "voxel_encoder.Dense_1")
    venc, w.out = w.out, {}
    for name in graph_net_mlps(cfg):
        prefix = f"graph_net.{name}.Dense_"
        n = len({k.split(".")[2] for k in state_dict if k.startswith(prefix)})
        for i in range(n):
            w.layer(f"{TRACKING_MLPS[name]}.layers.{2 * i}", f"{prefix}{i}")
    gnet, w.out = w.out, {}
    w.layer("fc1", "edge_classifier.Dense_0")
    w.layer("fc2", "edge_classifier.Dense_1")
    return venc, gnet, w.out


def save_torch_state_dict(path: str, sd: Mapping[str, Any],
                          envelope: bool = True) -> None:
    """torch.save a state_dict of numpy arrays or tensors; envelope=True
    wraps it as detectron2 does ({"model": sd})."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v, order="C", copy=True)) for k, v in sd.items()}
    torch.save({"model": sd} if envelope else sd, path)
