"""Flax parameter trees -> the port's `state_dict`s.

The port's modules carry the flax submodule names (`backbone.resnet.res2_0.
Conv_0`, `voxel_encoder.Dense_1`, ...), so a flax leaf path joined with dots
names its torch parameter; only the layouts differ.  The port keeps its own
copies of the layout rules (the JAX package's `importers/torch_export.py`
holds the same tables for detectron2 export):

  - Conv kernel (k..., I, O) -> weight (O, I, k...);
  - ConvTranspose kernel (k..., I, O) -> weight (I, O, k...) with the
    spatial axes flipped: flax does not flip the kernel
    (`transpose_kernel=False`), torch's transposed convolution does.  A
    transposed convolution is known by its module name: flax's automatic
    `ConvTranspose_i`, or the NOCS bin towers' `l1_r` .. `l3_b`;
  - Dense kernel (I, O) -> Linear weight (O, I);
  - GroupNorm and AffineChannelNorm scale -> weight (both of the port's
    norm layers call their parameters `weight` and `bias`, and every norm
    layer has the same name in both trees, so the rule needs no mode);
  - BoxHead `fc1_kernel` (7, 7, C, W) -> `fc1.weight` (W, 7 * 7 * C): the
    port flattens the pooled (7, 7, C) block channels-last, as flax
    contracts it, so the rows need no reordering (likewise the voxel
    encoder's Dense after its NDHWC flatten).

The inputs are nested dicts of numpy arrays (e.g. `jax.device_get` of
`model.init(...)`), with or without the top-level "params" key.  Any tree
of the params' structure maps the same way: a gradient tree, or the Adam
moments of an optax state (`adamw_state_dict`), so a port run can continue
a JAX run step for step.  float64 leaves stay float64; any other leaf
becomes float32.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mot3d_tpu_torch.config import Config, DetectionConfig
from mot3d_tpu_torch.models.norms import check_norm

_TRANSPOSED = re.compile(r"ConvTranspose_\d+|l[123]_[rgb]")


def _conv(k: np.ndarray) -> np.ndarray:
    nd = k.ndim
    return np.transpose(k, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def _conv_transpose(k: np.ndarray) -> np.ndarray:
    nd = k.ndim
    k = k[(slice(None, None, -1),) * (nd - 2)]
    return np.transpose(k, (nd - 2, nd - 1) + tuple(range(nd - 2)))


def _leaf(path, value) -> tuple:
    """One flax leaf -> (torch key, array)."""
    *mods, name = path
    arr = np.asarray(value)
    if arr.dtype != np.float64:
        arr = arr.astype(np.float32)
    if name == "fc1_kernel":
        return ".".join(mods + ["fc1", "weight"]), arr.reshape(
            -1, arr.shape[-1]).T
    if name == "fc1_bias":
        return ".".join(mods + ["fc1", "bias"]), arr
    if name == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif _TRANSPOSED.fullmatch(mods[-1]):
            arr = _conv_transpose(arr)
        else:
            arr = _conv(arr)
        return ".".join(mods + ["weight"]), arr
    if name == "scale":
        return ".".join(mods + ["weight"]), arr
    if name == "bias":
        return ".".join(mods + ["bias"]), arr
    raise ValueError(f"unexpected flax parameter {'/'.join(path)}")


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_to_state_dict(flax_params: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """Any flax param tree of the JAX package's modules -> the state_dict
    of the port's module of the same name."""
    tree = flax_params.get("params", flax_params)
    return {key: torch.from_numpy(np.array(arr, order="C", copy=True))
            for key, arr in (_leaf(p, v) for p, v in _flatten(tree))}


def import_config(cfg: DetectionConfig) -> DetectionConfig:
    """The DetectionConfig variant a detector imported from the reference's
    checkpoint runs under: frozen-affine norms, the torch `view()` voxel
    reshape, detectron2's anchor offset 0.0 and the stage stride on the
    bottleneck's 1x1 convolution."""
    return dataclasses.replace(cfg, norm="affine", voxel_torch_reshape=True,
                               anchor_offset=0.0, stride_in_1x1=True)


def mask_rcnn_state_dict(flax_params: Mapping[str, Any],
                         cfg: Config) -> Dict[str, torch.Tensor]:
    """`mot3d_tpu.models.mask_rcnn.MaskRCNN` params (or a tree of their
    structure, such as their gradient) -> the state_dict of
    `mot3d_tpu_torch.models.mask_rcnn.MaskRCNN(cfg.detection)`."""
    check_norm(cfg.detection.norm)
    return flax_to_state_dict(flax_params)


def tracker_state_dict(flax_params: Mapping[str, Any],
                       cfg: Config) -> Dict[str, torch.Tensor]:
    """`mot3d_tpu.models.mpn.TrackerModel` params (or a tree of their
    structure) -> the state_dict of
    `mot3d_tpu_torch.models.mpn.TrackerModel(cfg.graph)`."""
    if cfg.graph.time_aware_mp:
        raise NotImplementedError(
            "graph.time_aware_mp=True is not ported yet: ROADMAP.md Queue 1, "
            "item 'Time-aware message passing'")
    return flax_to_state_dict(flax_params)


def adamw_state_dict(opt_state: Mapping[str, Any], model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> dict:
    """An `optax.adamw` state -> `optimizer.load_state_dict` input.

    opt_state: {"mu": tree, "nu": tree, "count": int}, the first and second
    moments and the update count of optax's `ScaleByAdamState`, as numpy;
    the trees have the params' structure.  `optimizer` is a
    `torch.optim.AdamW` over `model.parameters()` (one group, in
    `named_parameters` order); its hyperparameters are kept.  The LR
    schedule's position (count) is the caller's to set on its scheduler."""
    mu = flax_to_state_dict(opt_state["mu"])
    nu = flax_to_state_dict(opt_state["nu"])
    names = [n for n, _ in model.named_parameters()]
    if set(mu) != set(names) or set(nu) != set(names):
        raise ValueError("optax moments do not match the model's parameters")
    sd = optimizer.state_dict()
    step = torch.tensor(float(opt_state["count"]))
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    return sd
