"""Closed-loop sequence serving: `clients` spawned processes share the card,
each with its own copy of the program's serving step, and each sends one
25-frame sequence at a time through `make_sequence_infer_step(...)(batch,
draws=...)` and `outputs_to_host`, the next as soon as the last is on the
host.  The processes exchange numbers and numpy arrays over pipes, never
tensors, so nothing is made in /dev/shm.

Each client keeps, for the calls of its seed-drawn check sample, what
each stage of the program produced (detector, pose, graph + MPN); after
the window, with the program's state freed, the client judges them
against the plain reference (`compare.py`) and sends back the parts of
the readings.
In a `--trace 1` run each stage is timed with a synchronise and a span of
calls is profiled; after the window one client profiles a few calls
alone, keeping the inputs of their K1 and K3 kernels so that their work
can be counted (`counts.py`)."""

from __future__ import annotations

import gc
import multiprocessing as mp
import time
import traceback

import numpy as np

from benchmark import common
from benchmark import traffic as traffic_gen

STAGES = ("detect", "pose", "track")
# Calls that client 0 of a traced run profiles alone after the window.
SOLO_CALLS = 3


def _numpy(fields) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in fields._asdict().items()}


class _KernelInputs:
    """Keeps the validity inputs of the K1 and K3 calls made while
    `keep` is set (references only: no work on the device)."""

    def __init__(self):
        self.keep = False
        self.k1, self.k3 = [], []

    def install(self):
        from mot3d_tpu_torch.geometry import outlier
        from mot3d_tpu_torch.ops import nms

        knn, exact = outlier.knn_mean_dists, nms.exact_nms_mask

        def knn_kept(points, valid, cols, k):
            if self.keep:
                self.k1.append((valid, cols))
            return knn(points, valid, cols, k)

        def exact_kept(boxes, scores, valid, thresh):
            if self.keep:
                self.k3.append(valid)
            return exact(boxes, scores, valid, thresh)

        outlier.knn_mean_dists = knn_kept
        nms.exact_nms_mask = exact_kept

    def work(self) -> dict:
        from benchmark import counts
        out = {}
        for name, calls, fn in (("k1", self.k1, lambda a: counts.k1_work(*a)),
                                ("k3", self.k3, counts.k3_work)):
            ops = nbytes = 0.0
            for a in calls:
                o, b = fn(a)
                ops += o
                nbytes += b
            out[name] = {"calls": len(calls), "ops": ops, "bytes": nbytes}
        return out


def client_main(conn, client: int, c: dict, seed: int, trace: bool,
                device: str):
    """One client process: build, warm up, report ready, serve from the
    common start until the window's end, send back what it measured, then
    (client 0 of a traced run) profile a few calls alone, and judge what it
    kept."""
    try:
        common.setup_process()
        _client(conn, client, c, seed, trace, device)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def make_step(c: dict, seed: int, dev):
    """The program's serving step on the cell's configuration, with the
    seed's weights."""
    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.models.mpn import TrackerModel
    from mot3d_tpu_torch.parallel.infer_step import make_sequence_infer_step
    from mot3d_tpu_torch.tracking.graph_builder import make_template

    conf = c["config"]
    cfg = common.program_config(conf["config"])
    det = MaskRCNN(cfg.detection, device=dev)
    trk = TrackerModel(cfg.graph, device=dev)
    w_det, w_trk = common.model_weights(conf, seed, dev)
    det.load_state_dict(w_det)
    trk.load_state_dict(w_trk)
    d, t = cfg.detection, cfg.tracking
    template = make_template(t.seq_len, d.detections_per_image,
                             t.max_frame_dist)
    return make_sequence_infer_step(det, trk, template, cfg, device=dev)


def client_inputs(c: dict, seed: int, client: int) -> list:
    """(batch, draws) of the sequences client `client` cycles."""
    import torch

    from mot3d_tpu_torch.parallel.infer_step import SequenceBatch
    return [(SequenceBatch(**{k: v[None] for k, v in seq.items()}),
             torch.from_numpy(draws[None]))
            for seq, draws in traffic_gen.client_pool(
                seed, client, c["traffic"], c["config"]["config"])]


def check_calls(c: dict, seed: int, client: int) -> set:
    """The calls of client `client` whose outputs the check judges, drawn
    from the seed among its first calls."""
    chk = c["workload"]["check"]
    return set(int(k) for k in traffic_gen.rng_for(seed, 3, client).choice(
        chk["first_calls"], chk["per_client"], replace=False))


def kept_record(call: int, pool_size: int, stages: dict) -> dict:
    """What the check needs of a kept call, as numpy: each stage's outputs,
    the sequence outputs and the pool entry it served."""
    probs, obj_ids = stages["track"]
    return {"pool": call % pool_size, "detect": _numpy(stages["detect"]),
            "pose": _numpy(stages["pose"]),
            "track": {"edge_probs": probs.cpu().numpy(),
                      "obj_ids": obj_ids.cpu().numpy()},
            "out": stages["out"]}


def check_parts(c: dict, seed: int, client: int, checked: dict, dev,
                **control) -> dict:
    """{call: parts} of the client's kept calls, judged by the reference
    (`compare.sequence_parts`) in the client's own process: the kept
    outputs stay where they are (a pipe of the machine with the card
    moves some 10 MB/s)."""
    from benchmark import compare
    if not checked:
        return {}
    ref = compare.Reference(c["config"], seed, dev)
    pool = traffic_gen.client_pool(seed, client, c["traffic"],
                                   c["config"]["config"])
    return {call: compare.sequence_parts(ref, pool[rec["pool"]], rec,
                                         **control)
            for call, rec in checked.items()}


def _client(conn, client, c, seed, trace, device):
    import torch

    from benchmark import profiling as tr
    from mot3d_tpu_torch.parallel.infer_step import outputs_to_host

    dev = torch.device(device)
    step = make_step(c, seed, dev)
    pool = client_inputs(c, seed, client)
    check = check_calls(c, seed, client)

    prof = tr.Profile(STAGES) if trace else None
    kernel_inputs = _KernelInputs()
    if trace:
        kernel_inputs.install()
        tr.Profile.warm(dev)
    state = {"call": -1, "timed": False}
    kept = {}
    stage_s = {s: 0.0 for s in STAGES}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def wrap(stage, fn):
        def run(*args, **kwargs):
            with tr.label(stage, trace and prof.on):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if state["timed"]:
                    sync()
                    stage_s[stage] += time.perf_counter() - t0
            if state["call"] in check:
                kept.setdefault(state["call"], {})[stage] = out
            return out
        return run

    for stage in STAGES:
        setattr(step, stage, wrap(stage, getattr(step, stage)))

    # Warm-up: every shape the traffic uses (all its sequences share them).
    for batch, draws in pool[:1]:
        outputs_to_host(step(batch, draws=draws))
    sync()
    for s in STAGES:
        stage_s[s] = 0.0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    conn.send(("ready", None))
    _, start, end, t_stage, t_prof, prof_s = conn.recv()
    while time.perf_counter() < start:
        time.sleep(0.0005)

    # A traced run times the stages (each ending in a synchronise) from
    # t_stage and profiles prof_s seconds of calls from t_prof.
    calls, stage_calls = [], 0
    k = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= end:
            break
        if trace:
            state["timed"] = t_stage <= t0 < t_prof
            if prof.prof is None and t0 >= t_prof:
                prof.start()
        state["call"] = k
        batch, draws = pool[k % len(pool)]
        out = outputs_to_host(step(batch, draws=draws))
        t1 = time.perf_counter()
        calls.append((t0, t1))
        stage_calls += state["timed"]
        if trace and prof.on:
            prof.calls += 1
            if t1 >= prof.t0 + prof_s:
                prof.stop()
        if k in kept:
            kept[k]["out"] = {f: np.asarray(v) for f, v in
                              out._asdict().items()}
        k += 1
    if trace and prof.on:
        prof.stop()
    sync()
    loaded = common.forbidden_loaded()
    if loaded:
        raise common.BenchError(f"modules that must not load were loaded: "
                                f"{loaded}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = prof.summary() if trace else None
    if trace:
        summary["stage_s"] = stage_s
        summary["stage_calls"] = stage_calls
    conn.send(("window", {"calls": calls, "peak": peak, "trace": summary}))

    # Client 0 of a traced run profiles SOLO_CALLS calls while the other
    # clients wait, so that its kernels' device times are their own (the
    # window's spans stretch where four processes time-slice the card).
    msg = conn.recv()
    if msg[0] == "solo":
        state.update(timed=False, call=-1)
        solo = tr.Profile(STAGES)
        solo.start()
        kernel_inputs.keep = True
        for j in range(SOLO_CALLS):
            batch, draws = pool[(k + j) % len(pool)]
            outputs_to_host(step(batch, draws=draws))
            solo.calls += 1
        solo.stop()
        kernel_inputs.keep = False
        conn.send(("solo", {"kernels": solo.summary()["kernels"],
                            "calls": solo.calls,
                            "work": kernel_inputs.work()}))
        msg = conn.recv()

    checked = {call: kept_record(call, len(pool), stages)
               for call, stages in kept.items() if "out" in stages}
    # The program's state is freed before the reference runs.
    del kept, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    parts = check_parts(c, seed, client, checked, dev)
    conn.send(("done", {"parts": parts, "check": sorted(check)}))


def _recv(conn, what: str):
    try:
        return conn.recv()
    except EOFError:
        raise common.BenchError(f"a client ended without a word {what}")


def run(c: dict, seed: int, seconds: float, trace: bool, device="cuda",
        t_process: float = 0.0) -> dict:
    """The serving cell: clients, window, then the check.  Returns the
    measured numbers, the kept outputs and the traces."""
    traf = c["traffic"]
    n = traf["clients"]
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    for client in range(n):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=client_main,
                        args=(child, client, c, seed, trace, device))
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)

    def receive(tag, what):
        out = []
        for conn in conns:
            got, msg = _recv(conn, what)
            if got != tag:
                raise common.BenchError(f"a client failed {what}:\n{msg}")
            out.append(msg)
        return out
    try:
        receive("ready", "in set-up")
        start = time.perf_counter() + 0.05
        end = start + seconds
        tw = traf["trace_window"]
        t_stage = start + tw["stages_from"] * seconds
        t_prof = start + tw["profile_from"] * seconds
        setup_s = start - t_process
        for conn in conns:
            conn.send(("go", start, end, t_stage, t_prof,
                       tw["profile_seconds"]))
        results = receive("window", "in the window")
        solo = None
        if trace:
            conns[0].send(("solo",))
            tag, solo = _recv(conns[0], "profiling alone")
            if tag != "solo":
                raise common.BenchError(f"a client failed profiling "
                                        f"alone:\n{solo}")
        for conn in conns:
            conn.send(("check",))
        for r, done in zip(results, receive("done", "in the check")):
            r.update(done)
        check_s = time.perf_counter() - end
    finally:
        common.end_processes(procs)
    frames = c["config"]["config"]["tracking"]["seq_len"]
    done = [(t0, t1) for r in results for t0, t1 in r["calls"] if t1 <= end]
    lat = [(t1 - t0) * 1e3 for t0, t1 in done]
    out = {"setup_s": setup_s, "window_s": seconds,
           "sequences": len(done), "attempted": sum(len(r["calls"])
                                                     for r in results),
           "frames_per_s": len(done) * frames / seconds,
           "seq_p95_ms": float(np.percentile(lat, 95)) if lat else None,
           "memory_peak_bytes": sum(r["peak"] for r in results),
           "check_s": check_s, "results": results, "solo": solo}
    if trace:
        # The traced run's rate before its stages are timed or profiled.
        plain = sum(1 for r in results for _, t1 in r["calls"]
                    if t1 <= t_stage)
        out["plain_rate"] = plain / (t_stage - start)
    return out
