"""Parity of the port's tracking half (graph builder, TrackerModel, flax
parameter import) against the JAX package, on the CPU.

Tolerances: graph fields exact, edge_attr atol 1e-5 (differences of
float32 translations and a log ratio).  Tracker logits atol 1e-4: a 3D CNN
over 32^3 grids and four message-passing steps of float32 matmuls summed in
a different order by XLA and by torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mot3d_tpu.config import Config, GraphConfig, TrackingConfig
from mot3d_tpu.geometry.transforms import aabb_corners
from mot3d_tpu.models.mpn import TrackerModel as TrackerJ
from mot3d_tpu.tracking import graph_builder as gb_j
from mot3d_tpu_torch.importers.flax_params import tracker_state_dict
from mot3d_tpu_torch.models.mpn import TrackerModel as TrackerT
from mot3d_tpu_torch.tracking import graph_builder as gb_t
from torch_port_helpers import port_config, random_params, to_torch

torch.set_num_threads(1)


def _sequence(t_frames=4, i_slots=3, g=3, seed=0):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-2, 2, (g, 3)).astype(np.float32)
    half = rng.uniform(0.3, 0.8, (g, 3)).astype(np.float32)
    box = np.asarray(jax.vmap(aabb_corners)(jnp.asarray(ctr - half),
                                            jnp.asarray(ctr + half)))
    gt = np.stack([box] * t_frames)                             # (T, G, 8, 3)
    # Detections: noisy copies of the GT boxes in shuffled slots, one
    # false positive far away, one invalid slot.
    pred = np.zeros((t_frames, i_slots, 8, 3), np.float32)
    trans = np.zeros((t_frames, i_slots, 3), np.float32)
    valid = np.ones((t_frames, i_slots), bool)
    for t in range(t_frames):
        perm = rng.permutation(g)[:i_slots]
        for i, gi in enumerate(perm):
            off = rng.normal(0, 0.05, 3).astype(np.float32)
            pred[t, i] = gt[t, gi] + off
            trans[t, i] = ctr[gi] + off
        pred[t, -1] += 10.0 if t % 2 else 0.0
    valid[1, 0] = False
    rot = rng.uniform(-1, 1, (t_frames, i_slots, 3)).astype(np.float32)
    scales = rng.uniform(0.5, 2, (t_frames, i_slots)).astype(np.float32)
    ids = np.tile(np.arange(g, dtype=np.int32) + 7, (t_frames, 1))
    gt_valid = np.ones((t_frames, g), bool)
    gt_valid[2, 1] = False
    return valid, trans, rot, scales, pred, gt, ids, gt_valid


@pytest.mark.parametrize("with_targets", [True, False])
@pytest.mark.parametrize("undirected", [True, False])
def test_build_graph_matches_jax(with_targets, undirected):
    cfg = TrackingConfig(seq_len=4, max_instances_per_frame=3,
                         max_frame_dist=2, undirected=undirected)
    tmpl_j = gb_j.make_template(4, 3, 2)
    tmpl_t = gb_t.make_template(4, 3, 2)
    for a, b in zip(tmpl_j, tmpl_t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    arrays = _sequence()
    out_j = jax.jit(lambda *a: gb_j.build_graph(
        tmpl_j, cfg, *a, with_targets=with_targets))(
        *map(jnp.asarray, arrays))
    out_t = gb_t.build_graph(tmpl_t, port_config(Config(tracking=cfg)).tracking,
                             *map(to_torch, arrays),
                             with_targets=with_targets)
    if with_targets:
        ids = np.asarray(out_j.obj_ids)
        assert (ids >= 0).sum() > 4 and (ids < 0).sum() > 1
    for name in out_j._fields:
        a, b = np.asarray(getattr(out_j, name)), getattr(out_t, name).numpy()
        if name == "edge_attr":
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_tracker_model_matches_jax_with_converted_params():
    gcfg = GraphConfig()
    model_j = TrackerJ(gcfg)
    rng = np.random.default_rng(1)
    n_nodes, e = 6, 20
    vox = (rng.uniform(size=(n_nodes, 32, 32, 32)) < 0.3).astype(np.float32)
    src = rng.integers(0, n_nodes, e).astype(np.int32)
    dst = rng.integers(0, n_nodes, e).astype(np.int32)
    attr = rng.normal(size=(e, gcfg.edge_in_dim)).astype(np.float32)
    mask = rng.uniform(size=e) > 0.3
    args = (jnp.asarray(vox), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(attr), jnp.asarray(mask))
    params = random_params(model_j, *args)
    logits_j = jax.jit(model_j.apply)(params, *args)

    cfg_t = port_config(Config(graph=gcfg))
    model_t = TrackerT(cfg_t.graph, device="cpu")
    model_t.load_state_dict(tracker_state_dict(jax.device_get(params), cfg_t),
                            strict=True)
    with torch.no_grad():
        logits_t = model_t(*(to_torch(a) for a in (vox, src, dst, attr,
                                                   mask)))
    assert logits_t.shape == (gcfg.num_mp_steps - 1, e)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=1e-4, rtol=0)


def test_tracker_rejects_unported_options():
    """Every GraphConfig option of the JAX package is ported (time-aware
    message passing since its flow MLPs landed); an aggregation no package
    knows is refused."""
    cfg = port_config(Config(graph=GraphConfig(time_aware_mp=True)))
    model = TrackerT(cfg.graph, device="cpu")
    assert {"flow_in", "flow_out", "node_fuse"} <= {
        n for n, _ in model.graph_net.named_children()}
    bad = port_config(Config(graph=GraphConfig(node_agg_fn="median")))
    with pytest.raises(ValueError, match="node_agg_fn"):
        TrackerT(bad.graph, device="cpu")
