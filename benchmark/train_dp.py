"""The data-parallel detection training cell: one spawned process per rank,
each on its own card with its own `DetectionTrainer`, joined in the
program's process group (`parallel/multihost.py:init_distributed`: NCCL
with a card a rank) and data mesh (`parallel/mesh.py:make_mesh`).  Every
rank starts from rank 0's weights and averages the ranks' gradients before
each AdamW step (`train.make_trainer`).

At step k rank r trains on the pool's batch (ranks * k + r) % pool, with
sampler draws from a generator of its own, seeded from (seed, r).  The
ranks agree, by an all-reduce (MAX) of a few integers in a gloo group on
the host, whether the window has ended and, traced, whether to start or
stop the profiler; each rank posts its vote before a step and acts on the
previous vote's result, so that no rank waits on the host for another to
finish a step, every rank makes the same steps, none is left in an
unmatched collective, and the card is not synchronised for it.  The
window ends with a synchronise and a barrier on every rank.  A traced run
profiles the same steps on every rank.

The check: the first three steps (set-up) keep every rank's losses, draws
and selected proposals, and rank 0's gradient norms at step 1 and
parameter changes after step 3.  After the window the ranks read
`replica_gap`, the largest absolute difference between rank 0's
parameters and any other rank's, and end; then the reference follows the
three steps on one card (`train.reference_steps`,
`reference/dp_steps.py`)."""

from __future__ import annotations

import gc
import multiprocessing as mp
import shutil
import socket
import tempfile
import time
import traceback
from multiprocessing import connection

from benchmark import common
from benchmark import traffic as traffic_gen
from benchmark import train

# Seconds the parent waits for a word from the ranks before it ends them.
WAIT_S = 300.0


def batch_index(step: int, rank: int, ranks: int, pool: int) -> int:
    """The pool's batch that rank `rank` trains on at step `step`."""
    return (ranks * step + rank) % pool


def draw_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s sampler draws."""
    return int(traffic_gen.rng_for(seed, 5, rank).integers(2 ** 62))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(conn, rank: int, c: dict, jobs: list, trace: bool,
              device: str, coordinator: str):
    """One rank: join the group, then for each job (seed, seconds) build,
    set up, step for the window and send back its record."""
    t_rank = time.perf_counter()
    try:
        common.setup_process()
        import torch.distributed as dist

        from mot3d_tpu_torch.parallel.mesh import make_mesh
        from mot3d_tpu_torch.parallel.multihost import init_distributed
        dev = init_distributed(coordinator, c["traffic"]["ranks"], rank,
                               device)
        mesh = make_mesh(device=dev)
        host_group = dist.new_group(backend="gloo")
        t_joined = time.perf_counter()
        for seed, seconds in jobs:
            record = rank_job(rank, c, seed, seconds, trace, mesh, host_group)
            record["phases"].setdefault("rank", t_rank)
            record["phases"].setdefault("joined", t_joined)
            t_rank = t_joined = None
            conn.send(("job", record))
        dist.destroy_process_group()
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _numpy(tensors) -> tuple:
    return tuple(x.cpu().numpy() for x in tensors)


def replica_gap(model, mesh) -> float:
    """The largest absolute difference between rank 0's parameters and
    this rank's, the largest over the ranks."""
    import torch
    import torch.distributed as dist
    flat = torch.cat([p.detach().reshape(-1).float()
                      for p in model.parameters()])
    if mesh.backend != "nccl":
        flat = flat.cpu()
    first = flat.clone()
    dist.broadcast(first, src=0)
    gap = (flat - first).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def rank_job(rank: int, c: dict, seed: int, seconds: float, trace: bool,
             mesh, host_group) -> dict:
    import torch
    import torch.distributed as dist

    from benchmark import compare
    from benchmark import profiling as tr
    from mot3d_tpu_torch.models.mask_rcnn import DetectionDraws

    phases = {"job": time.perf_counter()}
    conf, traf = c["config"], c["traffic"]
    ranks, b = traf["ranks"], traf["batch"]
    dev = mesh.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    scratch = tempfile.mkdtemp(prefix="bench-train-")
    w_det, _ = common.model_weights(conf, seed, dev)
    start_params = {k: v.clone() for k, v in w_det.items()} \
        if rank == 0 else None
    phases["weights"] = time.perf_counter()
    trainer = train.make_trainer(common.program_config(conf["config"]),
                                 scratch, dev, w_det, mesh)
    del w_det
    phases["trainer"] = time.perf_counter()
    pool = train.device_pool(traffic_gen.detection_batches(
        seed, traf, conf["config"]), dev)
    phases["pool"] = time.perf_counter()
    anchors, rois = train.draw_shapes(conf)
    gen = torch.Generator(device=dev).manual_seed(draw_seed(seed, rank))

    def step(k):
        draws = train.draws_for(gen, b, anchors, rois, dev, DetectionDraws)
        batch = pool[batch_index(k, rank, ranks, len(pool))]
        return trainer.train_step(batch, draws), draws

    prog = train.checked_steps(step, trainer.model, trainer.state.optimizer)
    phases["checked_steps"] = time.perf_counter()
    if rank == 0:
        prog["changes"] = compare.changes(trainer.model, start_params)
    del start_params
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    prof = tr.Profile(("step",)) if trace else None
    tw = traf["trace_window"]
    if trace:
        tr.Profile.warm(dev)
    phases["set_up"] = time.perf_counter()
    dist.barrier(group=host_group)
    start = time.perf_counter()
    end = start + seconds
    t_prof = start + tw["profile_from"] * seconds
    k, steps, plain_rate = train.CHECKED_STEPS, 0, None
    # Before each step every rank votes (past the window's end, past the
    # profile's start, past its end; MAX over the ranks) without waiting,
    # and acts on the vote before: the ranks drift apart by a step at most
    # and never wait on the host for the slowest to finish a step.
    voted = None
    while True:
        now = time.perf_counter()
        vote = torch.tensor([now >= end, trace and now >= t_prof,
                             trace and prof.on and
                             now >= prof.t0 + tw["profile_seconds"]],
                            dtype=torch.int64)
        work = dist.all_reduce(vote, op=dist.ReduceOp.MAX, group=host_group,
                               async_op=True)
        if voted is not None:
            voted[0].wait()
            past_end, past_start, past_stop = voted[1].tolist()
            if past_end:
                break
            if past_stop and prof.on:
                prof.stop()
            if past_start and prof.prof is None:
                prof.start()            # synchronises first
                plain_rate = steps / (prof.t0 - start)
        voted = (work, vote)
        with tr.label("step", trace and prof.on):
            step(k)
        k += 1
        steps += 1
        if trace and prof.on:
            prof.calls += 1
    work.wait()
    if trace and prof.on:
        prof.stop()
    sync()
    dist.barrier(group=host_group)
    window = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = prof.summary() if trace else None
    gap = replica_gap(trainer.model, mesh)
    loaded = common.forbidden_loaded()
    if loaded:
        raise common.BenchError(f"modules that must not load were loaded: "
                                f"{loaded}")
    record = {"steps": steps, "start": start, "window_s": window,
              "phases": phases, "peak": peak, "trace": summary,
              "plain_rate": plain_rate, "replica_gap": gap,
              "losses": prog["losses"],
              "draws": [_numpy(d) for d in prog["draws"]],
              "proposals": [_numpy(p) for p in prog["proposals"]]}
    if rank == 0:
        record.update(grads=prog["grads"], changes=prog["changes"])
    del trainer, pool, step, prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    shutil.rmtree(scratch, ignore_errors=True)
    return record


def spawn(c: dict, jobs: list, trace: bool, device: str) -> list:
    """Run `jobs` [(seed, seconds)] one after another on `ranks` spawned
    processes; per job, the ranks' records in rank order.  A rank that
    fails, ends without a word or is silent for WAIT_S seconds ends them
    all."""
    ranks = c["traffic"]["ranks"]
    ctx = mp.get_context("spawn")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs, conns = [], []
    for rank in range(ranks):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=rank_main, args=(child, rank, c, jobs, trace,
                                                device, coordinator))
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    out = [[None] * ranks for _ in jobs]
    done = [0] * ranks
    try:
        pending = list(conns)
        while pending:
            ready = connection.wait(pending, timeout=WAIT_S)
            if not ready:
                raise common.BenchError(f"no rank sent a word in {WAIT_S} s")
            for conn in ready:
                rank = conns.index(conn)
                try:
                    tag, msg = conn.recv()
                except EOFError:
                    raise common.BenchError(f"rank {rank} ended without a "
                                            f"word")
                if tag != "job":
                    raise common.BenchError(f"rank {rank} failed:\n{msg}")
                out[done[rank]][rank] = msg
                done[rank] += 1
                if done[rank] == len(jobs):
                    pending.remove(conn)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        common.end_processes(procs)
    return out


def check(c: dict, seed: int, records: list, dev) -> dict:
    """The readings of one job: the reference follows the three set-up
    steps on `dev` from every rank's batches, draws and proposals; the
    program's losses are the ranks' means, its gradients and changes
    rank 0's; `proposal_unmatched` is over every rank's step-1 proposals;
    `replica_gap` the ranks' reading."""
    import torch

    from benchmark import compare
    traf = c["traffic"]
    ranks = traf["ranks"]
    host = traffic_gen.detection_batches(seed, traf, c["config"]["config"])
    steps = range(len(records[0]["losses"]))

    def on_dev(arrays):
        return tuple(torch.from_numpy(x).to(dev) for x in arrays)
    batches = [[host[batch_index(k, r, ranks, len(host))]
                for r in range(ranks)] for k in steps]
    draws = [[on_dev(rec["draws"][k]) for rec in records] for k in steps]
    proposals = [on_dev(rec["proposals"][k]) for k in steps
                 for rec in records]
    ref = train.reference_steps(c["config"], seed, batches, draws, proposals,
                                dev, ranks=ranks)
    first = records[0]

    def joined(per_rank):      # every rank's (boxes, scores, valid), joined
        return [tuple(torch.cat(parts) for parts in zip(*per_rank))]
    prog = {"losses": [{t: sum(rec["losses"][k][t] for rec in records)
                        / ranks for t in first["losses"][k]} for k in steps],
            "grads": first["grads"], "changes": first["changes"],
            "proposals": joined([tuple(map(torch.from_numpy,
                                           rec["proposals"][0]))
                                 for rec in records])}
    ref["proposals"] = joined(ref["proposals"][:ranks])
    readings = compare.train_readings(prog, ref)
    readings["replica_gap"] = max(rec["replica_gap"] for rec in records)
    return readings


SET_UP = ("rank", "joined", "job", "weights", "trainer", "pool",
          "checked_steps", "set_up")


def set_up_phases(t_spawn: float, phases: dict) -> dict:
    """Seconds of rank 0's set-up by phase: from the spawn to the rank's
    start (an interpreter and the harness), its imports and the group's
    join, the seed's weights, the trainer (with the NCCL communicator's
    set-up at its first collective), the pool on the card, the
    three checked steps, what follows them (rank 0's changes, the
    profiler's warm-up), the barrier."""
    marks = [t_spawn] + [phases[p] for p in SET_UP] + [phases["start"]]
    names = ("spawn", "imports_join", "to_job", "weights", "trainer",
             "pool", "checked_steps", "after_checked", "barrier")
    return {n: b - a for n, a, b in zip(names, marks, marks[1:])}


def run(c: dict, seed: int, seconds: float, trace: bool, device="cuda",
        t_process: float = 0.0) -> dict:
    import torch
    t_spawn = time.perf_counter()
    records = spawn(c, [(seed, seconds)], trace, device)[0]
    traf = c["traffic"]
    ranks, b = traf["ranks"], traf["batch"]
    counts = sorted({rec["steps"] for rec in records})
    if len(counts) != 1:
        raise common.BenchError(f"the ranks made different numbers of "
                                f"steps: {counts}")
    steps, first = counts[0], records[0]
    window = max(rec["window_s"] for rec in records)
    t_check = time.perf_counter()
    readings = check(c, seed, records, torch.device(device))
    readings["check_s"] = time.perf_counter() - t_check
    readings["set_up_s"] = dict(before_spawn=t_spawn - t_process,
                                **set_up_phases(t_spawn, {
                                    **first["phases"],
                                    "start": first["start"]}))
    return {"setup_s": first["start"] - t_process, "window_s": window,
            "steps": steps, "attempted": steps, "images": steps * b * ranks,
            "train_images_per_s": steps * b * ranks / window,
            "memory_peak_bytes": max(rec["peak"] for rec in records),
            "cards": ranks, "trace": first["trace"],
            "card_traces": [rec["trace"] for rec in records] if trace
            else None,
            "plain_rate": first["plain_rate"], "readings": readings}
