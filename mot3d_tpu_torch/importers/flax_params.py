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
becomes float32.  The layout does not depend on the detector's compute
dtype: parameters stay float32 under `detection.compute_dtype="bfloat16"`
(flax's `dtype=` casts them per call, as the port's `norms.compute_in`
does), so a bf16 model loads the same float32 state_dict.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from mot3d_tpu_torch.config import Config
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
    return flax_to_state_dict(flax_params)


def siamese_state_dict(flax_params: Mapping[str, Any],
                       cfg: Config) -> Dict[str, torch.Tensor]:
    """`mot3d_tpu.models.siamese.SiameseTracker` params (or a tree of their
    structure) -> the state_dict of
    `mot3d_tpu_torch.models.siamese.SiameseTracker(cfg.siamese)`."""
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


def _adam_moments(opt_state) -> Optional[Mapping[str, Any]]:
    """The `ScaleByAdamState` (mu, nu, count) inside an optax chain state
    (nested tuples of NamedTuples, as numpy) as a dict."""
    if all(hasattr(opt_state, k) for k in ("mu", "nu", "count")):
        return {"mu": opt_state.mu, "nu": opt_state.nu,
                "count": opt_state.count}
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_moments(sub)
            if found is not None:
                return found
    return None


def import_train_state(jax_state, state) -> Any:
    """A JAX trainer state -> the port's, in place: a
    `DetectionTrainState` or `TrackingTrainState` of the JAX package
    (params, optax AdamW state, step; as numpy, e.g. `jax.device_get` of
    it) into the port's `DetectionTrainState` / `TrackingTrainState`
    (model, torch AdamW, `LambdaLR`, step).  The model takes the params,
    the optimizer the Adam moments and count, the scheduler the schedule's
    position, so a JAX-started run continues in the port step for step.
    Returns `state`."""
    params, opt_state, step = jax_state
    state.model.load_state_dict(flax_to_state_dict(params))
    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (mu, nu, count) found")
    state.optimizer.load_state_dict(
        adamw_state_dict(adam, state.model, state.optimizer))
    count = int(adam["count"])
    sched = state.scheduler
    sched.last_epoch = count
    for group, base, fn in zip(state.optimizer.param_groups, sched.base_lrs,
                               sched.lr_lambdas):
        group["lr"] = base * fn(count)
    state.step = int(step)
    return state
