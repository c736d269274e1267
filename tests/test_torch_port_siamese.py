"""The port's siamese (non-graph) tracker against the JAX package's, on the
CPU: `SiameseTracker` under each ablation (in_dim 32, 24 and 8), the BCE,
L1 and triplet losses and `mine_triplets`, one train step against JAX's
`make_siamese_train_step` (compiled once, SGD at LR 1 on both sides so the
new parameters are the old ones minus the gradient), `validate`, and the
`--precompute` feature cache.

Inputs are the JAX package's synthetic sequences (`data/synthetic.py`) on a
tiny template (3 frames, 4 slots); weights are random JAX params carried
over by `importers/flax_params.py:siamese_state_dict`.  Tolerances: logits,
losses, gradients and parameters rtol = atol = 1e-5 (float32 on both
sides); MOTA and IDF1 to 1e-12 (the same trajectories give the same
counts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mot3d_tpu.config import Config as ConfigJ
from mot3d_tpu.config import SiameseConfig, TrackingConfig
from mot3d_tpu.data.synthetic import synthetic_sequence
from mot3d_tpu.models import siamese as siamese_j
from mot3d_tpu.train import siamese_trainer as trainer_j
from mot3d_tpu.train.tracking_trainer import \
    sequences_to_batch as to_batch_j
from mot3d_tpu_torch.importers.flax_params import siamese_state_dict
from mot3d_tpu_torch.models import siamese as siamese_t
from mot3d_tpu_torch.parallel.train_step import TrackingBatch
from mot3d_tpu_torch.tracking.graph_builder import build_graph, make_template
from mot3d_tpu_torch.train.siamese_trainer import (SiameseTrainer,
                                                   SiameseTrainState)
from mot3d_tpu_torch.train.tracking_trainer import sequences_to_batch
from torch_port_helpers import jit_run, port_config, random_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ABLATIONS = {"default": {}, "no_pose": {"no_pose": True},
             "no_geo": {"no_geo": True}}


def _cfg(**siamese) -> ConfigJ:
    return ConfigJ().replace(
        tracking=TrackingConfig(seq_len=3, max_instances_per_frame=4,
                                max_frame_dist=1),
        siamese=SiameseConfig(**siamese))


def _seqs(cfg, n, seed0=0):
    return [{k: np.asarray(v) for k, v in synthetic_sequence(
        cfg.tracking, seed=seed0 + i, num_objects=3, noise=0.01)
        ._asdict().items()} for i in range(n)]


def _params(cfg, trainer, seed=0):
    """Random JAX params of `trainer`'s SiameseTracker (from shapes only)."""
    t = trainer.trk_cfg
    n = t.seq_len * t.max_instances_per_frame
    e = len(trainer.template.src_frame)
    return jax.tree_util.tree_map(np.asarray, random_params(
        trainer.model, jnp.zeros((n, 32, 32, 32)), jnp.zeros(e, jnp.int32),
        jnp.zeros(e, jnp.int32), jnp.zeros((e, 7)), jnp.zeros(e, bool),
        seed=seed))


def _graph(trainer, seq):
    """The directed dt == 1 graph of one sequence (the port's builder,
    whose parity with JAX's is tests/test_torch_port_tracking.py's), as
    numpy, and the sequence's voxels."""
    trk = port_config(ConfigJ(tracking=trainer.trk_cfg)).tracking
    one = TrackingBatch(*(torch.as_tensor(x[0]).to(
        torch.bool if k in ("det_valid", "gt_valid") else
        torch.int32 if k == "gt_ids" else torch.float32)
        for k, x in zip(TrackingBatch._fields, sequences_to_batch([seq]))))
    g = build_graph(make_template(trk.seq_len, trk.max_instances_per_frame,
                                  1), trk, one.det_valid, one.translations,
                    one.rotations, one.scales, one.pred_boxes, one.gt_boxes,
                    one.gt_ids, one.gt_valid)
    return type(g)(*(x.numpy() for x in g)), one.voxels.numpy()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's trainer at the default ablation on random params: one
    compiled SGD step on two sequences and `validate` on two others."""
    out = tmp_path_factory.mktemp("siamese_j")
    cfg = _cfg()
    tj = trainer_j.SiameseTrainer(cfg, str(out))
    params = _params(cfg, tj)
    seqs = {"train": _seqs(cfg, 2), "val": _seqs(cfg, 2, 10)}
    sgd = optax.sgd(1.0)
    state, metrics = jit_run(trainer_j.make_siamese_train_step(
        tj.model, tj.template, cfg, sgd, tj.trk_cfg),
        trainer_j.SiameseTrainState(params, sgd.init(params),
                                    jnp.zeros((), jnp.int32)),
        to_batch_j(seqs["train"]))
    tj.state = trainer_j.SiameseTrainState(params, None, 0)
    return dict(cfg=cfg, params=params, seqs=seqs,
                loss=float(metrics["siamese_loss"]),
                stepped=jax.device_get(state.params),
                val=tj.validate(seqs["val"], classwise=True), trainer=tj)


def _port(cfg, params, tmp_path):
    tt = SiameseTrainer(port_config(cfg), str(tmp_path), device="cpu")
    tt.init_state(params=siamese_state_dict(params, port_config(cfg)))
    return tt


@pytest.mark.parametrize("ablation", list(ABLATIONS))
def test_forward_matches_jax(jax_run, ablation, tmp_path):
    """Logits and embeddings of each ablation's model on one sequence's
    pairs; the classifier's input width is 32, 24 or 8."""
    cfg = _cfg(**ABLATIONS[ablation])
    tj = trainer_j.SiameseTrainer(cfg, str(tmp_path / "j"))
    params = _params(cfg, tj, seed=1)
    graph, vox = _graph(tj, jax_run["seqs"]["train"][0])
    rel = np.asarray(siamese_j.siamese_edge_features(graph.edge_attr))
    args = (vox.reshape(-1, 32, 32, 32), graph.src, graph.dst, rel,
            graph.edge_mask)
    logits_j, h_j = jit_run(tj.model.apply, params, *map(jnp.asarray, args))
    tt = _port(cfg, params, tmp_path / "t")
    width = {"default": 32, "no_pose": 24, "no_geo": 8}[ablation]
    assert tt.model.classifier.Dense_0.in_features == width
    with torch.no_grad():
        logits_t, h_t = tt.model(*map(torch.from_numpy, args))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    assert (h_t is None) == (h_j is None) == (ablation == "no_geo")
    if h_t is not None:
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)


def test_losses_and_triplet_mining_match_jax(jax_run):
    """BCE (with its clamps), L1, mine_triplets and the triplet loss on one
    sequence's pairs, with and without a valid mask."""
    cfg = jax_run["cfg"]
    tj = jax_run["trainer"]
    graph, _ = _graph(tj, jax_run["seqs"]["train"][1])
    rng = np.random.default_rng(2)
    e, n = len(graph.src), tj.trk_cfg.seq_len * 4
    logits = (rng.normal(size=e) * 3).astype(np.float32)
    logits[:3] = [150.0, -150.0, 0.0]         # beyond the logit clamp
    h = rng.normal(size=(n, 12)).astype(np.float32)
    s = cfg.siamese

    @jax.jit
    def jax_losses(logits, targets, mask, h, src, dst):
        mined = siamese_j.mine_triplets(h, src, dst, targets, mask)
        return mined, {
            "bce": siamese_j.siamese_bce_loss(logits, targets, mask,
                                              s.pos_weight_max,
                                              s.logit_clamp),
            "l1": siamese_j.siamese_l1_loss(logits, targets, mask),
            "triplet": siamese_j.triplet_loss(*mined, s.triplet_margin)}

    for mask in (graph.edge_mask, np.zeros_like(graph.edge_mask)):
        args = (logits, graph.targets, mask)
        mined_j, want = jax_losses(*map(jnp.asarray, (
            logits, graph.targets, mask, h, graph.src, graph.dst)))
        mined_t = siamese_t.mine_triplets(*map(torch.from_numpy, (
            h, graph.src, graph.dst, graph.targets, mask)))
        for a, b in zip(mined_j, mined_t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        got = {"bce": siamese_t.siamese_bce_loss(
                   *map(torch.from_numpy, args), s.pos_weight_max,
                   s.logit_clamp),
               "l1": siamese_t.siamese_l1_loss(*map(torch.from_numpy, args)),
               "triplet": siamese_t.triplet_loss(*mined_t,
                                                 s.triplet_margin)}
        for name, a in want.items():
            np.testing.assert_allclose(float(got[name]), float(a),
                                       err_msg=name, **TOL)
    assert bool(np.asarray(mined_j[3]).any()) or not mask.any()
    # No valid anchor: the mean over none is 0, like torch's.
    assert float(siamese_t.triplet_loss(*mined_t[:3])) > 0


def test_train_step_matches_jax(jax_run, tmp_path):
    """One SGD step at LR 1 on two sequences: the same loss, and new
    parameters equal to JAX's."""
    cfg = jax_run["cfg"]
    tt = _port(cfg, jax_run["params"], tmp_path)
    opt = torch.optim.SGD(tt.model.parameters(), lr=1.0)
    state = SiameseTrainState(
        tt.model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda n: 1.0))
    state, metrics = tt._step(False)(
        state, sequences_to_batch(jax_run["seqs"]["train"]))
    assert state.step == 1 and jax_run["loss"] > 0
    np.testing.assert_allclose(float(metrics["siamese_loss"]),
                               jax_run["loss"], **TOL)
    want = siamese_state_dict(jax_run["stepped"], port_config(cfg))
    moved = 0
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
        moved += not np.array_equal(
            want[name].numpy(), siamese_state_dict(
                jax_run["params"], port_config(cfg))[name].numpy())
    assert moved > 0


def test_validate_matches_jax(jax_run, tmp_path):
    tt = _port(jax_run["cfg"], jax_run["params"], tmp_path)
    res_t = tt.validate(jax_run["seqs"]["val"], classwise=True,
                        export_dir=str(tmp_path / "vis"))
    res_j = jax_run["val"]
    assert sorted(res_t) == sorted(res_j)
    for k, v in res_j.items():
        tol = 1e-12 if k in ("mota", "idf1") or k.startswith("mota_") \
            else 1e-5
        assert res_t[k] == pytest.approx(float(v), rel=tol, abs=tol), k
    assert (tmp_path / "vis" / "seq_001" / "replay.html").exists()


def test_precompute_equals_direct_training_and_round_trips(jax_run,
                                                           tmp_path):
    """A step from precomputed features gives the direct step's loss and
    the same edge-encoder and classifier parameters (the encoder gets no
    gradient from the cache); the cache read back from .npz files equals
    what was written; train(precompute=True) runs and checkpoints."""
    cfg, params = jax_run["cfg"], jax_run["params"]
    seqs = jax_run["seqs"]["train"]
    batch = sequences_to_batch(seqs)
    direct = _port(cfg, params, tmp_path / "a")
    cached = _port(cfg, params, tmp_path / "b")
    cache = str(tmp_path / "cache")
    feats = cached.precompute_features(seqs, cache_dir=cache)
    again = cached.precompute_features(seqs, cache_dir=cache)
    for a, b in zip(feats, again):
        np.testing.assert_array_equal(a, b)
    _, m_direct = direct._step(False)(direct.state, batch)
    _, m_pre = cached._step(True)(cached.state, batch, np.stack(feats))
    np.testing.assert_allclose(float(m_pre["siamese_loss"]),
                               float(m_direct["siamese_loss"]), **TOL)
    pd = dict(direct.model.named_parameters())
    for name, p in cached.model.named_parameters():
        if not name.startswith("voxel_encoder."):
            np.testing.assert_allclose(p.detach().numpy(),
                                       pd[name].detach().numpy(),
                                       err_msg=name, **TOL)
    trainer = SiameseTrainer(port_config(_cfg(use_triplet=True)),
                             str(tmp_path / "c"), device="cpu")
    res = trainer.train(seqs, jax_run["seqs"]["val"][:1], num_epochs=1,
                        precompute=True, cache_dir=str(tmp_path / "c2"))
    assert np.isfinite(res["val_loss"]) and trainer.state.step == 1
    assert trainer.ckpt.all_steps() == [1]
    with pytest.raises(ValueError):
        SiameseTrainer(port_config(_cfg(no_pose=True, no_geo=True)),
                       str(tmp_path / "d"), device="cpu")
