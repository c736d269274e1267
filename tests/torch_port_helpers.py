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


def to_torch(a):
    return torch.from_numpy(np.array(a))
