"""The readings the limits of `correct` are set from, on the card at the
cell's own sizes, in one process (no measured window):

    python3 benchmark/calibrate.py --workload <cell> --seeds N [--first S]
        [--control-seeds M] [--faults F,..|all]

For each seed, the program's outputs of the sequences (or first training
steps) a run checks, judged as a run judges them (a data-parallel cell's
ranks spawned once for every seed, control and fault, the references then
spread over the cards); then the control on
`--control-seeds` seeds: the detector in bfloat16 (the program's own
path, `detection.compute_dtype`), and pose and graph + MPN as the
reference computed in TF32 put in the program's place; with `--faults`,
the named faults a cell can have, planted in the program
(`tests/faults.py`).  One JSON
line per reading, also written to `chiprun_out/calibrate-<cell>.jsonl`;
a serving reading's per-pair gaps go to
`chiprun_out/pairs/<cell>/<run>-<seed>.npz`.
Not part of a run."""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing as mp
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common  # noqa: E402

CONTROL = "bfloat16"


def serve_readings(c, seed, dev, plant=""):
    """A run's check of the serving cell without its window: every
    client's checked calls, in one process, through the program's step
    with `plant` planted (`tests/faults.py`).  (readings, parts)."""
    import torch

    from benchmark import compare, serve
    from benchmark.tests import faults
    from mot3d_tpu_torch.parallel.infer_step import outputs_to_host

    step = faults.build_step(plant, c, seed, dev)
    last = {}
    for stage in serve.STAGES:
        fn = getattr(step, stage)

        def keep(*a, _fn=fn, _stage=stage, **k):
            last[_stage] = _fn(*a, **k)
            return last[_stage]
        setattr(step, stage, keep)
    checked = []
    for client in range(c["traffic"]["clients"]):
        pool = serve.client_inputs(c, seed, client)
        for call in sorted(serve.check_calls(c, seed, client)):
            batch, draws = pool[call % len(pool)]
            out = outputs_to_host(step(batch, draws=draws))
            stages = dict(last)
            stages["out"] = {f: v for f, v in out._asdict().items()}
            checked.append((client, call,
                            serve.kept_record(call, len(pool), stages)))
    del step, last
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    parts = []
    control = plant == CONTROL
    for client in range(c["traffic"]["clients"]):
        mine = {call: rec for cl, call, rec in checked if cl == client}
        parts += list(serve.check_parts(c, seed, client, mine, dev,
                                        pose_tf32=control,
                                        track_tf32=control).values())
    return compare.summarise(parts, c["workload"]["check"]["far"]), parts


def train_readings(c, seed, dev, plant=""):
    """The training cell's readings of its checked steps (no window), with
    `plant` planted in the trainer."""
    from benchmark import train
    from benchmark.tests import faults
    make = train.make_trainer
    if plant:
        train.make_trainer = faults.trainer_maker(plant)
    try:
        return train.run(c, seed, 0.0, False, device=dev)["readings"]
    finally:
        train.make_trainer = make


def _check_part(conn, c, items, device):
    """One card's share of the data-parallel references: (seed, records)
    -> readings."""
    try:
        common.setup_process()
        conn.send(("ok", _checks(c, items, device)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _checks(c, items, device) -> list:
    import torch

    from benchmark import train_dp
    out = []
    for seed, records in items:
        out.append(train_dp.check(c, seed, records, torch.device(device)))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def dp_train_readings(c, runs, devices) -> list:
    """The data-parallel training cell's readings of its checked steps (no
    window) for each of `runs` [(kind, seed, plant)]: the ranks spawned
    once for all of them, each run's plant planted in every rank while it
    runs (`faults.training_rank`); then the references, run i's on
    `devices[i % len(devices)]`, one process a device."""
    from benchmark import train_dp
    from benchmark.tests import faults
    target = train_dp.rank_main
    train_dp.rank_main = functools.partial(faults.training_rank,
                                           [p for _, _, p in runs])
    try:
        records = train_dp.spawn(c, [(seed, 0.0) for _, seed, _ in runs],
                                 False, devices[0].split(":")[0])
    finally:
        train_dp.rank_main = target
    items = [(seed, rec) for (_, seed, _), rec in zip(runs, records)]
    if len(devices) == 1:
        return _checks(c, items, devices[0])
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    for i, device in enumerate(devices):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_check_part, args=(
            child, c, items[i::len(devices)], device))
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    try:
        parts = []
        for conn in conns:
            tag, msg = conn.recv()
            if tag != "ok":
                raise common.BenchError(f"a reference failed:\n{msg}")
            parts.append(msg)
    finally:
        common.end_processes(procs)
    return [parts[i % len(devices)][i // len(devices)]
            for i in range(len(runs))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=3_000_000_000)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="",
                    help="comma-separated faults to plant, or 'all'")
    args = ap.parse_args()
    common.setup_process()
    c = common.cell(args.workload)
    cards = c["entry"]["chips"]
    common.require_cards(cards)
    import numpy as np
    import torch

    from benchmark.compare import HEAD_KEYS
    from benchmark.tests import faults
    from mot3d_tpu_torch.ops.cuda.build import build
    build()
    serving = c["traffic"]["kind"] == "sequences"
    ranks = c["traffic"].get("ranks", 1)
    dev = torch.device("cuda")
    out = ROOT / "chiprun_out" / f"calibrate-{args.workload}.jsonl"
    pairs = ROOT / "chiprun_out" / "pairs" / args.workload
    pairs.mkdir(parents=True, exist_ok=True)
    ident = common.card_identity()

    def emit(kind, seed, readings, t0):
        line = {"workload": args.workload, "run": kind, "seed": seed,
                "seconds": time.perf_counter() - t0,
                "card": ident["kind"], "power_limit": ident["power_limit"],
                **readings}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")

    runs = [("program", s, "") for s in range(args.seeds)]
    runs += [(CONTROL, s, CONTROL) for s in range(args.control_seeds)]
    every = faults.SERVE if serving else \
        faults.TRAIN_DP if ranks > 1 else faults.TRAIN
    chosen = every if args.faults == "all" else \
        [f for f in args.faults.split(",") if f]
    runs += [(f"fault:{f}", s, f) for f in chosen
             for s in range(args.control_seeds)]
    if ranks > 1:
        runs = [(kind, args.first + 7919 * s, plant)
                for kind, s, plant in runs]
        t0 = time.perf_counter()
        got = dp_train_readings(c, runs, [f"cuda:{i}" for i in range(cards)])
        for (kind, seed, _), r in zip(runs, got):
            emit(kind, seed, r, t0)
        return 0
    for kind, s, plant in runs:
        seed = args.first + 7919 * s
        t0 = time.perf_counter()
        if serving:
            r, parts = serve_readings(c, seed, dev, plant)
            np.savez(pairs / f"{kind.replace(':', '-')}-{seed}.npz",
                     **{k: np.concatenate([np.asarray(p[k], np.float64)
                                           .reshape(-1) for p in parts])
                        for k in (*HEAD_KEYS, "gaps")})
        else:
            r = train_readings(c, seed, dev, plant)
        emit(kind, seed, r, t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
