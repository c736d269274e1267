"""Shared helpers of the tests/test_torch_port_*.py parity tests: carry a JAX
package config into the port's config, and rebuild the JAX package's RANSAC
draws so both frameworks consume the same random numbers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mot3d_tpu_torch import config as port_cfg


def port_config(cfg):
    """mot3d_tpu Config -> the same values as a mot3d_tpu_torch Config."""
    sections = {}
    for f in dataclasses.fields(cfg):
        sec = getattr(cfg, f.name)
        cls = getattr(port_cfg, type(sec).__name__)
        sections[f.name] = cls(**{g.name: getattr(sec, g.name)
                                  for g in dataclasses.fields(sec)})
    return port_cfg.Config(**sections)


def slot_draws(key, i_slots, iters, sample_size):
    """The draws `postprocess_frame` makes from one frame key: split(key, I),
    then randint(k, (iters, S), 0, int32max) per slot -> (I, iters, S)."""
    keys = jax.random.split(key, i_slots)
    return np.stack([np.asarray(jax.random.randint(
        k, (iters, sample_size), 0, jnp.iinfo(jnp.int32).max))
        for k in keys]).astype(np.int64)


def sequence_draws(key, t_frames, i_slots, iters, sample_size):
    """The draws of one sequence in `make_sequence_infer_step`: split(key, T)
    then `slot_draws` per frame -> (T, I, iters, S)."""
    return np.stack([slot_draws(k, i_slots, iters, sample_size)
                     for k in jax.random.split(key, t_frames)])


def random_params(model, *args, seed=0, **kwargs):
    """Random flax params for `model.init(key, *args, **kwargs)`, made with
    numpy from the param shapes alone (`jax.eval_shape` traces, nothing is
    compiled): kernels N(0, 1/fan_in), biases N(0, 0.01), norm scales
    1 + N(0, 0.01)."""
    shapes = jax.eval_shape(lambda k: model.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "scale":
            return (1.0 + 0.01 * rng.normal(size=shape)).astype(np.float32)
        if "bias" in name:
            return (0.01 * rng.normal(size=shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def randomise_affine(tree, rng):
    """Non-trivial scale and bias for every frozen-affine norm of a flax
    param tree (the leaves of a {"scale", "bias"} module), in place."""
    for val in tree.values():
        if not isinstance(val, dict):
            continue
        if set(val) == {"scale", "bias"}:
            shape = val["scale"].shape
            val["scale"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            val["bias"] = rng.normal(0, 0.3, shape).astype(np.float32)
        else:
            randomise_affine(val, rng)
    return tree


def tame_affine_backbone(params):
    """Scale down the stem's affine norm and each bottleneck's last one, in
    place: frozen affines do not renormalise, so unit-variance random
    weights would otherwise blow 0..255 pixels up through the residual
    stages until every decoded box is clipped to the image border."""
    resnet = params["backbone"]["resnet"]
    resnet["stem_gn"]["scale"] = resnet["stem_gn"]["scale"] * 0.02
    for name, block in resnet.items():
        if name.startswith("res"):
            last = block["AffineChannelNorm_2"]
            last["scale"] = last["scale"] * 0.5
    return params


def to_torch(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, shape, extent=100.0, size=(5.0, 40.0)):
    xy = rng.uniform(0, extent, shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(*size, shape + (2,))],
                          -1).astype(np.float32)


def nms_cases():
    """name -> (boxes (..., K, 4), scores, valid, threshold): the inputs an
    exact NMS must get right (ties, chains, invalid rows, odd K, IoUs next
    to the threshold, leading batch dimensions)."""
    rng = np.random.default_rng(11)
    cases = {}

    def add(name, boxes, scores=None, valid=None, thresh=0.5):
        shape = boxes.shape[:-1]
        if scores is None:
            scores = rng.uniform(size=shape)
        if valid is None:
            valid = np.ones(shape, bool)
        cases[name] = (boxes.astype(np.float32), scores.astype(np.float32),
                       valid, thresh)

    for thr in (0.4, 0.7):
        add(f"random_{thr}", _boxes(rng, (64,)), thresh=thr)
    one = np.ones(64, bool)
    one[5] = False
    add("one_invalid", _boxes(rng, (64,)), valid=one)
    add("several_invalid", _boxes(rng, (64,)),
        valid=rng.uniform(size=64) < 0.6, thresh=0.4)
    add("tied_scores", _boxes(rng, (64,)), np.round(rng.uniform(size=64), 1))
    add("all_scores_equal", _boxes(rng, (40,)), np.zeros(40), thresh=0.4)
    add("identical_boxes", np.tile(np.float32([3, 4, 50, 60]), (70, 1)))
    k = 70
    slide = np.arange(k, dtype=np.float32)[:, None] * np.float32([4, 0, 4, 0])
    add("chain_depth_k", np.float32([0, 0, 10, 10]) + slide,
        np.linspace(1, 0, k), thresh=0.4)
    add("k_100", _boxes(rng, (100,)), thresh=0.7)
    add("k_129", _boxes(rng, (129,)), thresh=0.4)
    add("k_1", _boxes(rng, (1,)))
    add("all_invalid", _boxes(rng, (33,)), valid=np.zeros(33, bool))
    lo = rng.integers(0, 12, (90, 2))
    grid = np.concatenate([lo, lo + rng.integers(1, 8, (90, 2))], -1)
    for thr in (0.4, 0.7):
        add(f"integer_corners_{thr}", grid, thresh=thr)
    add("batch_dims", _boxes(rng, (2, 3, 37)),
        valid=rng.uniform(size=(2, 3, 37)) < 0.8, thresh=0.7)
    return cases


def _cloud(rng, b, n):
    """A dense cluster about the origin with a few far points per
    detection.  (Away from the origin the expanded d2 cancels: two orders
    of summation then differ by more than 1e-5 in the mean distance.)"""
    pts = rng.normal(size=(b, n, 3)).astype(np.float32) * 0.1
    pts[:, : max(1, n // 40)] *= 30.0
    return pts


def _subset(n, candidates):
    """`geometry/outlier.py:candidate_columns`' evenly spread columns."""
    return ((np.arange(candidates) * n + n // 2) // candidates).astype(
        np.int32)


def knn_cases():
    """name -> (points (B, N, 3) f32, valid (B, N) bool, cols (C,) int32, k):
    the inputs K1 must get right: every compiled top-k width (k = 1, 5, 7,
    12, 20, 32), C = 1 and C = 2048, duplicated points whose distances tie
    exactly, and detections whose points or candidates are all invalid or
    that have fewer than k valid candidates."""
    rng = np.random.default_rng(12)
    cases = {}

    def add(name, pts, valid, cols, k):
        cases[name] = (pts.astype(np.float32), valid.astype(bool),
                       np.asarray(cols, np.int32), k)

    def ragged(b, n):
        return np.arange(n)[None] < rng.integers(n // 4, n + 1, (b, 1))

    add("k1_subset", _cloud(rng, 2, 256), ragged(2, 256), _subset(256, 64),
        1)
    add("k5_subset", _cloud(rng, 3, 300), ragged(3, 300), _subset(300, 80),
        5)
    add("k7_full", _cloud(rng, 2, 200), rng.uniform(size=(2, 200)) < 0.7,
        np.arange(200), 7)
    add("k12_full", _cloud(rng, 2, 128), ragged(2, 128), np.arange(128), 12)
    add("k20_full", _cloud(rng, 2, 256), ragged(2, 256), np.arange(256), 20)
    add("k32_full", _cloud(rng, 2, 192), ragged(2, 192), np.arange(192), 32)
    add("c1", _cloud(rng, 2, 64), np.ones((2, 64), bool), [10], 1)
    add("c2048", _cloud(rng, 1, 2048), ragged(1, 2048), np.arange(2048), 9)
    # Multiples of 1/16 below 3 in magnitude: every product and sum of d2 is
    # exact in float32 whatever the order, so duplicates are at exactly 0
    # and equal distances tie exactly in every implementation.
    base = rng.integers(-48, 48, (2, 64, 3)) / 16.0
    dup = np.repeat(base, 4, axis=1)                 # each point 4 times
    dup_valid = np.ones((2, 256), bool)
    dup_valid[1, 200:] = False
    add("duplicates", dup, dup_valid, np.arange(256), 5)
    add("duplicates_subset", dup, dup_valid, _subset(256, 64), 2)
    cols = _subset(256, 64)
    degenerate = np.ones((4, 256), bool)
    degenerate[0] = False                            # every point invalid
    degenerate[1, cols] = False                      # every candidate invalid
    degenerate[2, cols[3:]] = False                  # 3 valid candidates < k
    add("degenerate_detections", _cloud(rng, 4, 256), degenerate, cols, 5)
    return cases
