"""The port's data parallelism on the CPU (`parallel/{mesh,multihost,
dryrun}.py`, the `mesh=` steps), against the JAX package and the port's
own one-process steps.

The one-process forms of `tests/test_multihost.py` come first.  Then two
ranks of `tests/_torch_parallel_worker.py`, started by `subprocess`, join
a gloo group through the MOT3D_* env-var rendezvous and run, on their rows
of each global batch (launched once, in a module fixture, while this
process computes the references):

  - the tracking step on 4 synthetic sequences, float64, SGD at LR 1, held
    against `mot3d_tpu.parallel.train_step.make_tracking_train_step` on
    the same global batch on one device: loss and new parameters to rtol
    1e-9, the parameters of both ranks bit-equal;
  - the combined step in its three modes (joint, accum_windows, two
    backwards) on the 2 tiny windows of `test_torch_port_train.py`,
    float64, draws from one seeded generator: the all-reduced gradients
    against the port's one-process step on both windows within 1e-10 of
    each leaf's scale (only the order of the sums differs), the metrics
    to rtol 1e-12, the updated parameters bit-equal across the ranks.  The
    one-process step is held against JAX in `test_torch_port_train.py`;
    the chain stands in for a second JAX combined-step oracle;
  - sharded serving of 4 sequences (2 per rank) against the unsharded run,
    which serves one sequence at a time: identities, validity and classes
    equal, translations, scores and edge probabilities within 1e-4 (the
    tolerance of `tests/test_parallel.py:193-202`).

`dryrun_multichip(2)` spawns its own two ranks.
"""

import copy
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _tiny_config
from mot3d_tpu.data.synthetic import synthetic_sequence
from mot3d_tpu.models import mpn as mpn_j
from mot3d_tpu.parallel import train_step as ts_j
from mot3d_tpu.tracking.graph_builder import make_template as template_j
from mot3d_tpu_torch.importers.flax_params import tracker_state_dict
from mot3d_tpu_torch.models.mpn import TrackerModel
from mot3d_tpu_torch.parallel import dryrun, mesh as mesh_t, multihost
from mot3d_tpu_torch.parallel import train_step as ts_t
from mot3d_tpu_torch.parallel.infer_step import (SequenceBatch,
                                                 make_sequence_infer_step)
from mot3d_tpu_torch.tracking.graph_builder import make_template
from test_torch_port_train import (_assert_grads, _batch, _close, _port_setup,
                                   _state, _tiny_port_cfg)
from torch_port_helpers import (COMBINED_MODES, finish_ranks, jit_run,
                                port_config, random_params, serving_inputs,
                                start_ranks)

torch.set_num_threads(1)



# ------------------------------------------------ one-process forms


def test_no_env_no_init(monkeypatch):
    for var in (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES,
                multihost.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert multihost.maybe_initialize_distributed() is False
    assert multihost.maybe_initialize_distributed("127.0.0.1:1", 1, 0) \
        is False
    assert multihost.is_main_process()
    assert multihost.global_batch_size(4) == 4


def test_rendezvous_needs_a_rank(monkeypatch):
    monkeypatch.setenv(multihost.ENV_COORDINATOR, "127.0.0.1:1")
    monkeypatch.setenv(multihost.ENV_NUM_PROCESSES, "2")
    monkeypatch.delenv(multihost.ENV_PROCESS_ID, raising=False)
    with pytest.raises(ValueError, match=multihost.ENV_PROCESS_ID):
        multihost.maybe_initialize_distributed(device="cpu")


def test_world_one_mesh_is_the_identity():
    """Without a process group the mesh is one rank: sharding, gathering,
    replication and averaging give their input back."""
    mesh = multihost.make_global_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend, mesh.axis) == \
        (1, 0, None, "data")
    assert mesh_t.make_mesh(1, device="cpu") == mesh
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    tree = {"x": x, "t": (torch.arange(4), [torch.ones(4, 2)])}
    for got in (mesh_t.shard_batch(mesh, tree),
                mesh_t.gather_batch(mesh, tree),
                mesh_t.replicate(mesh, tree),
                multihost.replicate_global(mesh, tree),
                multihost.host_local_batch_to_global(mesh, tree)):
        np.testing.assert_array_equal(np.asarray(got["x"]), x)
        assert torch.equal(got["t"][0], tree["t"][0])
        assert torch.equal(got["t"][1][0], tree["t"][1][0])
    metrics = {"a": torch.tensor(1.5)}
    assert mesh_t.all_mean(mesh, metrics) is metrics


def test_shard_batch_keeps_this_ranks_rows_and_refuses_an_uneven_batch():
    mesh = mesh_t.DataMesh(None, 1, 2, torch.device("cpu"), None)
    x = np.arange(8).reshape(4, 2)
    np.testing.assert_array_equal(mesh_t.shard_batch(mesh, x), x[2:])
    with pytest.raises(ValueError, match="does not divide"):
        mesh_t.shard_batch(mesh, {"x": np.zeros((3, 2))})


def test_mesh_spans_the_whole_group():
    with pytest.raises(ValueError, match="pass 0 or 1"):
        mesh_t.make_mesh(2, device="cpu")


def test_backend_rule():
    """NCCL only when no host holds more ranks than cards; gloo on the CPU
    and for ranks that share a card.  Decided per host: two hosts of four
    cards at world size 8 reduce over NCCL."""
    assert multihost.backend_for([("a", 0)] * 2) == "gloo"
    assert multihost.backend_for([("a", 1)] * 2) == "gloo"
    assert multihost.backend_for([("a", 1)]) == "nccl"
    assert multihost.backend_for([("a", 2)] * 2) == "nccl"
    assert multihost.backend_for([("a", 2)] * 4) == "gloo"
    assert multihost.backend_for([("a", 4)] * 4 + [("b", 4)] * 4) == "nccl"
    assert multihost.backend_for([("a", 4), ("b", 4)] * 4) == "nccl"
    assert multihost.backend_for([("a", 4)] * 5 + [("b", 4)] * 3) == "gloo"


def test_local_index_counts_ranks_on_the_same_host():
    """A rank's card is its index among its host's ranks, also when the
    hosts' ranks interleave."""
    places = [("a", 4), ("b", 4)] * 4
    assert [multihost.local_index(places, r) for r in range(8)] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    assert [multihost.local_index([("a", 2)] * 3, r) for r in range(3)] == \
        [0, 1, 2]


def test_placements_go_through_the_store():
    """Each rank posts (host, cards) and reads every rank's, in rank
    order; here one rank of a world of one on a local store."""
    store = torch.distributed.HashStore()
    assert multihost.placements(store, 1, 0, 3) == \
        [(socket.gethostname(), 3)]


def test_tiny_config_is_the_jax_dry_runs():
    assert dataclasses.asdict(dryrun.tiny_config()) == \
        dataclasses.asdict(port_config(_tiny_config()))


def test_device_prefetch_copies_this_ranks_rows():
    from mot3d_tpu_torch.data.prefetch import device_prefetch

    mesh = mesh_t.DataMesh(None, 1, 2, torch.device("cpu"), None)
    batches = [{"x": np.arange(8).reshape(4, 2) + 10 * i} for i in range(2)]
    got = list(device_prefetch(iter(batches), mesh=mesh))
    for g, b in zip(got, batches):
        assert torch.equal(g["x"], torch.from_numpy(b["x"][2:]))
    with pytest.raises(ValueError, match="mesh"):
        next(device_prefetch(iter(batches), device="meta", mesh=mesh))


def test_cli_initialises_distributed_first(monkeypatch):
    """`cli.main` makes the rendezvous before anything else, as the JAX
    CLI does (`mot3d_tpu/cli.py:255-259`), with the command's device."""
    from mot3d_tpu_torch import cli

    class Called(Exception):
        pass

    def rendezvous(**kw):
        raise Called(kw)

    monkeypatch.setattr(multihost, "maybe_initialize_distributed",
                        rendezvous)
    with pytest.raises(Called) as called:
        cli.main(["infer-tracking", "--data", "no_such_dir", "--ckpt", "x",
                  "--device", "cpu"])
    assert called.value.args[0] == {"device": "cpu"}


# ------------------------------------------------------ two ranks


def _tracking_inputs():
    cfg = _tiny_config()
    trk = cfg.tracking
    tmpl_args = (trk.seq_len, trk.max_instances_per_frame, trk.max_frame_dist)
    seqs = [synthetic_sequence(trk, seed=i, num_objects=3,
                               noise=0.01)._asdict() for i in range(4)]
    batch = {k: np.stack([np.asarray(sq[k]) for sq in seqs])
             for k in ts_j.TrackingBatch._fields}
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in batch.items()}
    e2 = 2 * len(template_j(*tmpl_args).src_frame)
    params = random_params(
        mpn_j.TrackerModel(cfg.graph),
        jnp.zeros((trk.seq_len * trk.max_instances_per_frame, 32, 32, 32)),
        jnp.zeros(e2, jnp.int32), jnp.zeros(e2, jnp.int32),
        jnp.zeros((e2, cfg.graph.edge_in_dim)), jnp.zeros(e2, bool), seed=4)
    cfg_t = port_config(cfg)
    model = TrackerModel(cfg_t.graph, device="cpu")
    model.load_state_dict(tracker_state_dict(params, cfg_t))
    return dict(cfg=cfg_t, template=make_template(*tmpl_args),
                model=model.double(), batch=batch), (cfg, tmpl_args, params)


def _tracking_oracle(cfg, tmpl_args, params, batch):
    """The JAX tracking step on the global batch, float64, SGD at LR 1."""
    with jax.enable_x64(True):
        sgd = optax.sgd(1.0)
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params)
        state, metrics = jit_run(ts_j.make_tracking_train_step(
            mpn_j.TrackerModel(cfg.graph), template_j(*tmpl_args), cfg, sgd),
            ts_j.TrackingTrainState(p64, sgd.init(p64), jnp.zeros((), int)),
            ts_j.TrackingBatch(**{k: jnp.asarray(v)
                                  for k, v in batch.items()}))
        return float(metrics["tracking_loss"]), jax.device_get(state.params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two workers, compute the references meanwhile, and return
    (the ranks' results, the references)."""
    work = tmp_path_factory.mktemp("ranks")
    tracking, oracle_args = _tracking_inputs()
    cfg = _tiny_port_cfg()
    det, trk = _port_setup(cfg)
    combined = dict(cfg=cfg, det=det, trk=trk, batch=_batch(cfg)._asdict(),
                    template=make_template(
                        2, cfg.detection.detections_per_image, 1),
                    modes=COMBINED_MODES, seed=11)
    serving = serving_inputs()
    procs = start_ranks(work, {"tracking": tracking, "combined": combined,
                               "serving": serving})
    try:
        ref = {"tracking": _tracking_oracle(*oracle_args,
                                            tracking["batch"]),
               "combined": {}}
        for mode, kw in COMBINED_MODES.items():
            d, t = copy.deepcopy(det), copy.deepcopy(trk)
            step = ts_t.make_combined_train_step(
                d, t, combined["template"], cfg, remat=False, device="cpu",
                **kw)
            _, metrics = step(_state(cfg, d, t), _batch(cfg),
                              generator=torch.Generator().manual_seed(11))
            ref["combined"][mode] = (
                metrics, [{n: p.grad for n, p in m.named_parameters()}
                          for m in (d, t)])
        serve = make_sequence_infer_step(
            serving["det"], serving["trk"], serving["template"],
            serving["cfg"], device="cpu")
        ref["serving"] = serve(SequenceBatch(**serving["batch"]),
                               generator=torch.Generator().manual_seed(7))
    finally:
        got = finish_ranks(procs, work)
    return got, ref


def test_rendezvous_through_the_env_vars(ranks):
    """MOT3D_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID make a gloo group
    of two on the CPU; rank 0 is the main process; `replicate_global`
    hands rank 0's values to both."""
    got, _ = ranks
    for r, out in enumerate(got):
        assert out["initialised"] and (out["rank"], out["size"]) == (r, 2)
        assert out["backend"] == "gloo" and out["main"] == (r == 0)
        assert out["global_batch"] == 4
        assert torch.equal(out["replicated"], torch.zeros(3))


def test_tracking_step_on_two_ranks_matches_jax(ranks):
    got, ref = ranks
    loss_j, params_j = ref["tracking"]
    want = tracker_state_dict(params_j, port_config(_tiny_config()))
    assert loss_j > 0
    for out in got:
        assert out["tracking"]["step"] == 1
        _close(out["tracking"]["loss"], loss_j, rtol=1e-9)
    for name, p in got[0]["tracking"]["params"].items():
        _close(p, want[name], rtol=1e-9, atol=1e-12, what=name)
        assert torch.equal(p, got[1]["tracking"]["params"][name]), name


@pytest.mark.parametrize("mode", list(COMBINED_MODES))
def test_combined_step_on_two_ranks_matches_one_process(ranks, mode):
    got, ref = ranks
    metrics, grads = ref["combined"][mode]
    assert float(metrics["tracking_loss"]) > 0
    for out in got:
        res = out["combined"][mode]
        assert res["step"] == 1
        for k, v in metrics.items():
            _close(res["metrics"][k], v.numpy(), rtol=1e-12, what=k)
        for m in (0, 1):
            _assert_grads(res["grads"][m], grads[m], tol=1e-10)
    for m in (0, 1):
        for name, p in got[0]["combined"][mode]["params"][m].items():
            assert torch.equal(p, got[1]["combined"][mode]["params"][m][
                name]), name


def test_sharded_serving_matches_unsharded(ranks):
    got, ref = ranks
    ref = ref["serving"]
    assert bool(ref.valid.any())
    for out in got:
        for name in ("obj_ids", "valid", "classes"):
            assert torch.equal(out["serving"][name], getattr(ref, name)), \
                name
        for name in ("translations", "scores", "edge_probs"):
            a, b = getattr(ref, name), out["serving"][name]
            assert bool(torch.isfinite(b).all()), name
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)


def test_dryrun_multichip_runs_on_the_gpu_by_default(monkeypatch):
    """Without a GPU the dry run raises before it spawns a rank, unless
    the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)


def test_dryrun_multichip_two_ranks():
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert out["ranks"] == 2 and out["backend"] == "gloo"
    assert out["combined"]["tracking_loss"] > 0
    assert out["tracking"]["tracking_loss"] > 0
    assert all(np.isfinite(v) for v in out["combined"].values())
