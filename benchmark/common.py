"""What every cell of the benchmark shares: the specs it finds by name, the
configurations as run, the weights it makes from the seed, the card's
identity and the result line.

The specs are files found by the names in `BENCHMARK.json`: a
configuration's `file`, `traffic/<traffic>.json` and
`workloads/<cell>.json`; a per-layer metric's reader is
`metrics/<metric>.py` (`readers`)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Whole top-level module names that no process of the benchmark may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mot3d_tpu")

# Published dense peaks of one NVIDIA H100 SXM (data sheet; at 700 W).
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


class BenchError(RuntimeError):
    """A run that cannot give a result: exits non-zero, prints none."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"{path} is missing: run from a checkout")
    return load_json(path)


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one cell runs by: its entry in BENCHMARK.json, its
    configuration, traffic and workload files, and the per-layer metrics
    it reports (their reader files under `metrics`)."""
    bench = benchmark_spec(root)
    here = root / HERE.name
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    return dict(
        name=name, entry=entry,
        config=load_json(root / conf["file"]),
        traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
        workload=load_json(here / "workloads" / f"{name}.json"),
        end_to_end=end_to_end, per_layer=per_layer,
        metrics_dir=str(here / "metrics"))


def readers(metrics: list, directory) -> dict:
    """name -> read(trace) of each per-layer metric, from
    `<directory>/<name>.py`."""
    out = {}
    for m in metrics:
        path = Path(directory) / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "metric_" + m["name"].replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = mod.read
    return out


# ----------------------------------------------------------- configuration

def config_from_dict(cls, data: dict):
    """A `Config` (the program's or the reference's class) holding the
    sections and fields of `data`, lists as tuples; every field must be
    given."""
    sections = {}
    for f in dataclasses.fields(cls):
        sec_cls = type(getattr(cls(), f.name))
        given = data[f.name]
        vals = {}
        for g in dataclasses.fields(sec_cls):
            v = given[g.name]
            vals[g.name] = tuple(v) if isinstance(v, list) else v
        if set(given) - set(vals):
            raise BenchError(f"unknown fields in section {f.name}: "
                             f"{sorted(set(given) - set(vals))}")
        sections[f.name] = sec_cls(**vals)
    return cls(**sections)


# ----------------------------------------------------------------- weights

def make_weights(model, seed: int, weights: dict, device) -> dict:
    """The state_dict of `model` (the reference's module structure: its
    keys and shapes) made on `device` from `seed` in two large draws.

    Convolution, transposed-convolution and linear weights and their
    biases are uniform in +-1/sqrt(fan_in), torch's default; GroupNorm
    scales 1 and biases 0; frozen-affine norm scales `affine_scale` +
    `affine_jitter` * N(0, 1) and biases `affine_bias` * N(0, 1); each
    entry of `weights["set"]` is filled with its value."""
    import torch
    from torch import nn

    params = [(n, p) for n, p in model.named_parameters()]
    total = sum(p.numel() for _, p in params)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    uni = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    nrm = torch.randn(total, generator=gen, device=device)
    fan = {}
    for mname, mod in model.named_modules():
        w = getattr(mod, "weight", None)
        if isinstance(w, nn.Parameter) and w.dim() >= 2:
            fan_in = w.shape[1] * math.prod(w.shape[2:])
            fan[mname] = fan_in
    kind = {mname: type(mod).__name__ for mname, mod in model.named_modules()}
    out, at = {}, 0
    for name, p in params:
        n = p.numel()
        mname, _, leaf = name.rpartition(".")
        u, z = uni[at:at + n].view(p.shape), nrm[at:at + n].view(p.shape)
        at += n
        if kind[mname] == "GroupNorm":
            val = torch.ones_like(u) if leaf == "weight" else \
                torch.zeros_like(u)
        elif kind[mname] == "AffineChannelNorm":
            val = (weights["affine_scale"] + weights["affine_jitter"] * z
                   if leaf == "weight" else weights["affine_bias"] * z)
        else:
            val = u / math.sqrt(fan[mname])
        out[name] = val.float().contiguous()
    for name, value in weights.get("set", {}).items():
        out[name] = torch.full_like(out[name], float(value))
    return out


def reference_models(cfg_ref, device):
    """The reference's detector and tracker (random-initialised; load the
    benchmark's weights into them)."""
    from benchmark.reference.models.mask_rcnn import MaskRCNN
    from benchmark.reference.models.mpn import TrackerModel
    return (MaskRCNN(cfg_ref.detection, device=device),
            TrackerModel(cfg_ref.graph, device=device))


def model_weights(conf: dict, seed: int, device):
    """(detector, tracker) state_dicts of a configuration from `seed`, made
    on the structure of the reference's models built on the meta device."""
    import torch
    from benchmark.reference.config import Config as RefConfig
    cfg = config_from_dict(RefConfig, conf["config"])
    with torch.device("meta"):
        det, trk = reference_models(cfg, "meta")
    w = conf["weights"]
    return (make_weights(det, seed, w["detector"], device),
            make_weights(trk, seed + 1, w["tracker"], device))


# ------------------------------------------------------------------ device

def require_cards(count: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: torch.cuda.is_available() is "
                         "False; the benchmark runs only on the GPU")
    if torch.cuda.device_count() < count:
        raise BenchError(f"the cell needs {count} GPUs, "
                         f"torch.cuda.device_count() is "
                         f"{torch.cuda.device_count()}")


def card_identity() -> dict:
    """The card's name and power limit, from nvidia-smi (the name from
    torch where nvidia-smi gives nothing)."""
    import torch
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return {"kind": torch.cuda.get_device_name(0),
            "power_limit": smi[0].split(",")[-1].strip() if smi else
            "not read"}


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def setup_process() -> None:
    """One host thread for the program's CPU ops, caches inside the
    checkout, no JAX through libraries that would load it."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    import torch
    torch.set_num_threads(1)
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def quartile_spread(values) -> float:
    import statistics
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)
