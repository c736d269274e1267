"""The benchmark of mot3d_tpu_torch on the GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

runs one cell of `BENCHMARK.json` from the root of a checkout: set-up
(weights and inputs from the seed, one warm call of every shape), a
measured window of `--seconds`, then the check of what the window's
path produced against the plain reference (`compare.py`).  With `--trace
0` the last line of standard output holds the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics, the device's busy and window
seconds and a breakdown.  The numbers compared and their limits come last
in that line and as the last lines of standard error.  Without a CUDA
device, or with JAX or the JAX package loaded, it exits non-zero and
prints no result."""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common  # noqa: E402


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}) for the numbers the cell
    compares; a number that is missing or not finite fails."""
    compared, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        compared[name] = {"value": value, "limit": limit}
    return ok, compared


def check_serving(res: dict, far: dict) -> dict:
    """The readings over every client's kept calls (each client judged its
    own against the reference after the window); a kept call that never
    came back fails."""
    from benchmark import compare
    parts, missing = [], 0
    for r in res["results"]:
        missing += len(set(r["check"]) - set(r["parts"]))
        parts += [r["parts"][call] for call in sorted(r["parts"])]
    readings = compare.summarise(parts, far)
    readings["never_came"] = missing
    readings["check_s"] = res["check_s"]
    return readings


def result_line(c, args, res, readings, ident) -> dict:
    limits = dict(c["workload"]["limits"])
    if "never_came" in readings:
        limits["never_came"] = 0
    ok, compared = judge(readings, limits)
    device = {"platform": "gpu", "kind": ident["kind"],
              "count": res.get("cards", 1),
              "memory_peak_bytes": int(res["memory_peak_bytes"]),
              "power_limit": ident["power_limit"]}
    line = {"correct": bool(ok), "attempted": int(res["attempted"]),
            "failed": 0}
    if args.trace:
        ctx = trace_context(c, res)
        metrics = {}
        read = common.readers(c["per_layer"], c["metrics_dir"])
        for m in c["per_layer"]:
            value = read[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = ctx["window_s"]
        line["metrics"] = metrics
        line["device"] = device
        from benchmark import profiling
        line["breakdown"] = profiling.breakdown(ctx["merged"])
    else:
        metrics = {}
        for m in c["end_to_end"]:
            value = res.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["metrics"] = metrics
        line["device"] = device
    line["readings"] = {k: v for k, v in readings.items()
                        if k not in compared}
    line["compared"] = compared
    return line


def trace_context(c: dict, res: dict) -> dict:
    """What the per-layer readers read: the merged profile of the traced
    span, the profile of the calls one client made alone after the window
    (its kernels and their counted work), stage times, rates and the
    frozen FLOP counts.  A data-parallel run's merged profile is its
    first rank's."""
    from benchmark import profiling
    if "results" in res:
        summaries = [r["trace"] for r in res["results"]]
        stage_s = {st: sum(s["stage_s"][st] for s in summaries)
                   for st in summaries[0]["stage_s"]}
        stage_calls = sum(s["stage_calls"] for s in summaries)
    else:
        summaries = [res["trace"]]
        stage_s, stage_calls = {}, 0
    merged = profiling.merge(summaries)
    busy, window = merged["busy_s"], merged["window_s"]
    if res.get("card_traces"):
        # One profile per card (data-parallel ranks): the busy and window
        # seconds of each card alone, averaged over the cards; kernels,
        # calls and gaps are the first card's.
        cards = [profiling.merge([s]) for s in res["card_traces"]]
        busy = sum(m["busy_s"] for m in cards) / len(cards)
        window = sum(m["window_s"] for m in cards) / len(cards)
    return {"merged": merged, "solo": res.get("solo"), "stage_s": stage_s,
            "stage_calls": stage_calls, "rate": res["plain_rate"],
            "flops": c["config"]["flops"], "traffic": c["traffic"],
            "busy_s": busy, "window_s": window,
            "occupancy": busy / window if window else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        common.setup_process()
        c = common.cell(args.workload)
        common.require_cards(c["entry"]["chips"])
        try:
            from mot3d_tpu_torch.ops.cuda.build import build
        except ImportError as e:
            raise common.BenchError(f"the program is not here: {e}")
        build()      # nvcc once, before the clients start
        common.program_config(c["config"]["config"], say=True)
        ident = common.card_identity()
        if c["traffic"]["kind"] == "sequences":
            from benchmark import serve
            res = serve.run(c, args.seed, args.seconds, bool(args.trace),
                            t_process=T_PROCESS)
            readings = check_serving(res, c["workload"]["check"]["far"])
        else:
            from benchmark import train
            res = train.run(c, args.seed, args.seconds, bool(args.trace),
                            t_process=T_PROCESS)
            readings = res["readings"]
        loaded = common.forbidden_loaded()
        if loaded:
            raise common.BenchError(
                f"modules that must not load were loaded: {loaded}")
        line = result_line(c, args, res, readings, ident)
    except common.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, v in line["compared"].items():
        print(f"compared {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
