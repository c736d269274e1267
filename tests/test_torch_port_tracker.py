"""Host trajectory assembly, MOTA/IDF1 and edge metrics of the port
(mot3d_tpu_torch.tracking.tracker, .mot_metrics, evaluator.edge_metrics)
against the JAX package's host code, on the same numpy inputs.

Graphs come from the JAX package's synthetic sequences (oracle edges, zero
edges, noisy edges) and from seeded random arrays with false positives and
duplicate identities in a frame.  Trajectories must be equal as lists
(frame, identity, class, location bit for bit); summaries equal to 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mot3d_tpu.config import TrackingConfig as TrackingConfigJ
from mot3d_tpu.data.synthetic import synthetic_sequence
from mot3d_tpu.evaluator.edge_metrics import edge_precision_recall_f1 as prf_j
from mot3d_tpu.tracking import Tracker as TrackerJ
from mot3d_tpu.tracking import build_graph as build_graph_j
from mot3d_tpu.tracking import mot_metrics as mm_j
from mot3d_tpu.tracking.graph_builder import make_template as template_j
from mot3d_tpu_torch.config import TrackingConfig as TrackingConfigT
from mot3d_tpu_torch.evaluator.edge_metrics import edge_precision_recall_f1
from mot3d_tpu_torch.tracking import mot_metrics as mm_t
from mot3d_tpu_torch.tracking.graph_builder import make_template
from mot3d_tpu_torch.tracking.tracker import Tracker

KW = dict(seq_len=8, max_instances_per_frame=4, max_frame_dist=3)
TCFG_J, TCFG_T = TrackingConfigJ(**KW), TrackingConfigT(**KW)


def _templates():
    args = (KW["seq_len"], KW["max_instances_per_frame"],
            KW["max_frame_dist"])
    tj, tt = template_j(*args), make_template(*args)
    for a, b in zip(tj, tt):
        np.testing.assert_array_equal(a, b)
    return tj, tt


def _assert_same_trajectories(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for da, db in zip(a, b):
            assert (da["scan_idx"], da["obj_idx"], da["cls"]) == \
                (db["scan_idx"], db["obj_idx"], db["cls"])
            np.testing.assert_array_equal(da["loc"], db["loc"])


def _assert_same_summary(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-12, key


@functools.lru_cache(maxsize=1)
def _build_graph_j():
    """JAX's graph builder at KW, compiled once for every case."""
    tj, _ = _templates()
    return jax.jit(lambda *a: build_graph_j(tj, TCFG_J, *a))


def _synthetic(edges, seed, **kw):
    """A synthetic sequence, its JAX-built graph identities, and edge
    probabilities: the oracle's, none, or the oracle's with noise."""
    seq = synthetic_sequence(TCFG_J, seed=seed, num_objects=3, **kw)
    tj, _ = _templates()
    graph = _build_graph_j()(
        jnp.array(seq.det_valid), jnp.array(seq.translations),
        jnp.array(seq.rotations), jnp.array(seq.scales),
        jnp.array(seq.pred_boxes), jnp.array(seq.gt_boxes),
        jnp.array(seq.gt_ids), jnp.array(seq.gt_valid))
    e = len(tj.src_frame)
    targets = np.asarray(graph.targets)[:e]
    rng = np.random.default_rng(seed)
    probs = {"oracle": targets, "zero": np.zeros(e),
             "noisy": np.clip(targets + rng.normal(0, 0.35, e), 0, 1)}[edges]
    return seq, np.asarray(graph.obj_ids), probs, targets


@pytest.mark.parametrize("edges,seed,kw", [
    ("oracle", 0, dict(noise=0.01, drop_prob=0.05, fp_prob=0.2)),
    ("oracle", 1, dict(noise=0.01)),
    ("zero", 0, {}),
    ("noisy", 2, dict(noise=0.05, drop_prob=0.1, fp_prob=0.3)),
    ("noisy", 3, dict(noise=0.2, drop_prob=0.3, fp_prob=0.5)),
])
def test_assemble_and_evaluate_match_jax(edges, seed, kw):
    seq, obj_ids, probs, targets = _synthetic(edges, seed, **kw)
    tj, tt = _templates()
    trk_j, trk_t = TrackerJ(TCFG_J), Tracker(TCFG_T)
    args = (probs, obj_ids, seq.det_valid, seq.translations, seq.classes)
    pred_j, pred_t = trk_j.assemble(tj, *args), trk_t.assemble(tt, *args)
    _assert_same_trajectories(pred_t, pred_j)
    gt_args = (seq.gt_ids, seq.gt_valid, seq.gt_locations, seq.gt_classes)
    gt_j, gt_t = trk_j.gt_trajectories(*gt_args), \
        trk_t.gt_trajectories(*gt_args)
    _assert_same_trajectories(gt_t, gt_j)
    assert len(gt_t) == 3
    if edges == "oracle":
        assert len(pred_t) >= 2

    _assert_same_summary(trk_t.evaluate(pred_t, gt_t),
                         trk_j.evaluate(pred_j, gt_j))
    (all_t, cls_t), (all_j, cls_j) = (trk_t.evaluate(pred_t, gt_t, True),
                                      trk_j.evaluate(pred_j, gt_j, True))
    _assert_same_summary(all_t, all_j)
    assert cls_t.keys() == cls_j.keys() and len(cls_t) >= 1
    for name in cls_j:
        _assert_same_summary(cls_t[name], cls_j[name])

    arrays = [(mm.TrajArrays.from_trajectories(p),
               mm.TrajArrays.from_trajectories(g))
              for mm, p, g in ((mm_t, pred_t, gt_t), (mm_j, pred_j, gt_j))]
    _assert_same_summary(
        mm_t.mot_summary_arrays(*arrays[0], TCFG_T.seq_len, 0.4),
        mm_j.mot_summary_arrays(*arrays[1], TCFG_J.seq_len, 0.4))

    mask = np.asarray(seq.det_valid)[tj.src_frame, tj.src_slot]
    for m in (None, mask):
        assert edge_precision_recall_f1(probs, targets, m) == \
            prf_j(probs, targets, m)


@pytest.mark.parametrize("seed", range(6))
def test_assemble_matches_jax_on_random_graphs(seed):
    """Identities with false positives (-1) and duplicates in a frame."""
    tj, tt = _templates()
    t, i = KW["seq_len"], KW["max_instances_per_frame"]
    r = np.random.default_rng(seed)
    args = (r.uniform(size=len(tj.src_frame)), r.integers(-1, 4, (t, i)),
            r.uniform(size=(t, i)) < 0.7, r.normal(size=(t, i, 3)),
            r.integers(0, 3, (t, i)))
    if seed == 0:
        args[2][3] = False        # an empty frame: "unique detections"
    _assert_same_trajectories(Tracker(TCFG_T).assemble(tt, *args),
                              TrackerJ(TCFG_J).assemble(tj, *args))


def test_accumulated_metrics_match_jax():
    summaries = []
    for edges, seed in (("oracle", 0), ("noisy", 2), ("zero", 1)):
        seq, obj_ids, probs, _ = _synthetic(edges, seed, noise=0.05,
                                            fp_prob=0.3)
        trk = Tracker(TCFG_T)
        pred = trk.assemble(_templates()[1], probs, obj_ids, seq.det_valid,
                            seq.translations, seq.classes)
        gt = trk.gt_trajectories(seq.gt_ids, seq.gt_valid, seq.gt_locations,
                                 seq.gt_classes)
        summaries.append(trk.evaluate(pred, gt))
    assert abs(mm_t.accumulated_mota(summaries)
               - mm_j.accumulated_mota(summaries)) <= 1e-12
    assert abs(mm_t.accumulated_idf1(summaries)
               - mm_j.accumulated_idf1(summaries)) <= 1e-12
    assert mm_t.accumulated_mota([]) == mm_j.accumulated_mota([]) == 1.0
    assert mm_t.accumulated_idf1([]) == mm_j.accumulated_idf1([]) == 1.0


def test_accumulator_events_match_jax():
    """The frame-by-frame accumulator on a stream with switches, misses,
    false positives and an absent object."""
    r = np.random.default_rng(4)
    acc_t, acc_j = mm_t.MOTAccumulator(), mm_j.MOTAccumulator()
    for _ in range(30):
        n_g, n_h = r.integers(0, 4), r.integers(0, 4)
        g = r.uniform(0, 1, (n_g, 3))
        h = r.uniform(0, 1, (n_h, 3))
        gi = r.choice(5, n_g, replace=False).tolist()
        hi = [f"h{j}" for j in r.choice(5, n_h, replace=False)]
        for acc, mm in ((acc_t, mm_t), (acc_j, mm_j)):
            acc.update(gi, hi, mm.norm2squared_matrix(g, h, 0.4))
    assert acc_t.events == acc_j.events
    assert acc_t.summary()["num_switches"] > 0
    _assert_same_summary(acc_t.summary(), acc_j.summary())


def test_template_longer_than_sequence_raises():
    _, tt = _templates()
    e = len(tt.src_frame)
    t, i = KW["seq_len"] - 1, KW["max_instances_per_frame"]
    with pytest.raises(ValueError, match="template spans"):
        Tracker(TCFG_T).assemble(tt, np.zeros(e), np.zeros((t, i), int),
                                 np.zeros((t, i), bool), np.zeros((t, i, 3)),
                                 np.zeros((t, i), int))


def test_traj_table_and_mot_summary_match_jax():
    pytest.importorskip("pandas")
    seq, obj_ids, probs, _ = _synthetic("noisy", 2, noise=0.05, fp_prob=0.3)
    tj, tt = _templates()
    trk_j, trk_t = TrackerJ(TCFG_J), Tracker(TCFG_T)
    args = (probs, obj_ids, seq.det_valid, seq.translations, seq.classes)
    gt_args = (seq.gt_ids, seq.gt_valid, seq.gt_locations, seq.gt_classes)
    tab_t = trk_t.traj_table(trk_t.assemble(tt, *args))
    tab_j = trk_j.traj_table(trk_j.assemble(tj, *args))
    assert tab_t.equals(tab_j) and len(tab_t) > 0
    assert list(trk_t.traj_table([]).columns) == list(tab_j.columns)
    gt_tab = trk_t.traj_table(trk_t.gt_trajectories(*gt_args))
    _assert_same_summary(mm_t.mot_summary(tab_t, gt_tab, 8, 0.4),
                         mm_j.mot_summary(tab_j, gt_tab, 8, 0.4))
    _assert_same_summary(mm_t.mot_summary(tab_t, gt_tab, 8, 0.4),
                         trk_t.evaluate(trk_t.assemble(tt, *args),
                                        trk_t.gt_trajectories(*gt_args)))
