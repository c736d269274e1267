"""What every cell of the benchmark shares: the specs it finds by name, the
configurations as run, the plain reference each names, the weights it
makes from the seed, the card's identity and the result line.

The specs are files found by the names in `BENCHMARK.json`: a
configuration's `file`, `traffic/<traffic>.json` and
`workloads/<cell>.json`; a per-layer metric's reader is
`metrics/<metric>.py` (`readers`); a configuration's reference is the
modules its file names under `"reference"` (`reference_modules`)."""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import importlib.util
import json
import math
import os
import subprocess
import sys
import types
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

def _parse(cls, data: dict, strict: bool) -> tuple:
    """(config, omitted): a `Config` of class `cls` holding the sections and
    fields of `data`, lists as tuples, and the dotted names of the fields
    `data` omits, which take the class's defaults, or are refused where
    `strict`.  Unknown sections and fields are refused."""
    default = cls()
    unknown = sorted(set(data) - {f.name for f in dataclasses.fields(cls)})
    if unknown:
        raise BenchError(f"unknown sections: {unknown}")
    sections, omitted = {}, []
    for f in dataclasses.fields(cls):
        section = getattr(default, f.name)
        given = data.get(f.name, {})
        names = [g.name for g in dataclasses.fields(section)]
        if set(given) - set(names):
            raise BenchError(f"unknown fields in section {f.name}: "
                             f"{sorted(set(given) - set(names))}")
        omitted += [f"{f.name}.{n}" for n in names if n not in given]
        sections[f.name] = dataclasses.replace(section, **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in given.items()})
    if strict and omitted:
        raise BenchError(f"fields missing: {omitted}")
    return cls(**sections), omitted


def config_from_dict(cls, data: dict):
    """A `Config` of class `cls` (a reference's) holding the sections and
    fields of `data`, lists as tuples; every field must be given."""
    return _parse(cls, data, strict=True)[0]


def program_config(data: dict, say: bool = False):
    """The program's `Config` of a configuration file's `config`.  Fields
    the file omits (ones the program gained after the file was written)
    take the program's defaults and, where `say`, are named on standard
    error; unknown fields are refused."""
    from mot3d_tpu_torch.config import Config
    cfg, omitted = _parse(Config, data, strict=False)
    if say and omitted:
        print(f"benchmark: the configuration omits {len(omitted)} fields of "
              f"the program's Config, which take its defaults: "
              f"{', '.join(omitted)}", file=sys.stderr)
    return cfg


# ----------------------------------------------------------------- weights

# Module classes, by name, whose scales make_weights sets to 1, biases to 0.
UNIT_NORMS = ("GroupNorm", "LayerNorm")


def make_weights(model, seed: int, weights: dict, device) -> dict:
    """The state_dict of `model` (the reference's module structure: its
    keys and shapes) made on `device` from `seed` in two large draws, a
    uniform and a normal one; each parameter reads both at its own offset
    in `named_parameters` order, whichever rule it takes.

    A parameter whose name matches a pattern of `weights["normal"]`
    (fnmatch pattern -> std, the first that matches) is std * N(0, 1).
    Otherwise the scales of a module whose class is named in `UNIT_NORMS`
    (torch's and a reference's own channel LayerNorm alike) are 1 and their
    biases 0; frozen-affine
    norm scales `affine_scale` + `affine_jitter` * N(0, 1) and biases
    `affine_bias` * N(0, 1); every other parameter (convolution,
    transposed-convolution and linear weights and their biases) uniform in
    +-1/sqrt(fan_in) of its module's weight, torch's default, and refused
    where that module has no weight of two or more dimensions.  Last, each
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
    normal = weights.get("normal", {})
    out, at = {}, 0
    for name, p in params:
        n = p.numel()
        mname, _, leaf = name.rpartition(".")
        u, z = uni[at:at + n].view(p.shape), nrm[at:at + n].view(p.shape)
        at += n
        std = next((s for pattern, s in normal.items()
                    if fnmatch.fnmatchcase(name, pattern)), None)
        if std is not None:
            val = float(std) * z
        elif kind[mname] in UNIT_NORMS:
            val = torch.ones_like(u) if leaf == "weight" else \
                torch.zeros_like(u)
        elif kind[mname] == "AffineChannelNorm":
            val = (weights["affine_scale"] + weights["affine_jitter"] * z
                   if leaf == "weight" else weights["affine_bias"] * z)
        elif mname in fan:
            val = u / math.sqrt(fan[mname])
        else:
            raise BenchError(
                f"no weight rule for parameter {name!r} ({kind[mname]}): "
                f"its module has no weight to give a fan-in; list a pattern "
                f"under weights.<model>.normal")
        out[name] = val.float().contiguous()
    for name, value in weights.get("set", {}).items():
        out[name] = torch.full_like(out[name], float(value))
    return out


# --------------------------------------------------------------- reference

# The plain reference a configuration runs by, where its file's
# `"reference"` names no other: role -> a dotted module under `benchmark.`.
REFERENCE = {"config": "benchmark.reference.config",
             "detector": "benchmark.reference.models.mask_rcnn",
             "tracker": "benchmark.reference.models.mpn"}
# What the harness takes from each role's module, and from the detector.
REFERENCE_NAMES = {"config": ("Config",),
                   "detector": ("MaskRCNN", "DetectionDraws", "GroundTruth"),
                   "tracker": ("TrackerModel",)}
DETECTOR_METHODS = ("predict", "num_proposals_train", "train_losses")


# Whole top-level names that no module of a plain reference may import.
NOT_IN_REFERENCE = ("mot3d_tpu_torch", *FORBIDDEN)


def _imported(path: Path, package: str) -> set:
    """The dotted names a source file imports anywhere in it: `a.b` of
    `import a.b`; `a.b` and `a.b.c` of `from a.b import c`, a relative
    one resolved against `package`."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = importlib.util.resolve_name(
                "." * node.level + (node.module or ""), package) \
                if node.level else node.module
            names |= {base, *(f"{base}.{a.name}" for a in node.names)}
    return names


def reference_sources(modules) -> dict:
    """path -> the dotted names it imports, for the source of each of
    `modules` and of every module under `benchmark.` that they import, at
    any depth.  Found without running them: only their packages are
    imported."""
    out, seen, todo = {}, set(), list(modules)
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        parent = name.rpartition(".")[0]
        try:
            if parent:
                pspec = importlib.util.find_spec(parent)
                if pspec is None or pspec.submodule_search_locations is None:
                    continue    # `c` of `from a.b import c`: no module
            spec = importlib.util.find_spec(name)
        except (ImportError, ValueError):
            continue
        if spec is None or not (spec.origin or "").endswith(".py"):
            continue
        package = name if spec.submodule_search_locations is not None \
            else parent
        out[Path(spec.origin)] = imported = _imported(Path(spec.origin),
                                                      package)
        todo += sorted(n for n in imported if n.split(".")[0] == "benchmark")
    return out


def reference_modules(conf: dict) -> types.SimpleNamespace:
    """The modules of a configuration's plain reference, imported: its
    file's `"reference"` over `REFERENCE`.  `proposals` is the module that
    defines the detector's `train_losses`, whose module-level
    `select_proposals` the training check swaps.  Refuses an unknown role,
    a module outside `benchmark.`, a reference that imports the program
    or JAX (itself or through a module under `benchmark.`, at any depth),
    and modules that lack what the harness takes from them, naming
    everything at fault."""
    given = conf.get("reference", {})
    if set(given) - set(REFERENCE):
        raise BenchError(f"unknown reference roles: "
                         f"{sorted(set(given) - set(REFERENCE))}")
    names = {**REFERENCE, **given}
    outside = sorted(m for m in names.values()
                     if not m.startswith("benchmark."))
    if outside:
        raise BenchError(f"reference modules outside benchmark.: {outside}")
    banned = {str(path): sorted(n for n in imported
                                if n.split(".")[0] in NOT_IN_REFERENCE)
              for path, imported in reference_sources(names.values()).items()}
    banned = {path: found for path, found in banned.items() if found}
    if banned:
        raise BenchError(f"the reference imports the program or JAX: "
                         f"{banned}")
    try:
        mods = {role: importlib.import_module(m) for role, m in names.items()}
    except ImportError as e:
        raise BenchError(f"a reference module does not import: {e}")
    missing = [f"{names[role]}.{a}" for role, attrs in REFERENCE_NAMES.items()
               for a in attrs if not hasattr(mods[role], a)]
    proposals = None
    det = getattr(mods["detector"], "MaskRCNN", None)
    if det is not None:
        missing += [f"{names['detector']}.MaskRCNN.{m}"
                    for m in DETECTOR_METHODS
                    if not callable(getattr(det, m, None))]
        if callable(getattr(det, "train_losses", None)):
            proposals = sys.modules[det.train_losses.__module__]
            if not hasattr(proposals, "select_proposals"):
                missing.append(f"{proposals.__name__}.select_proposals (the "
                               f"module that defines MaskRCNN.train_losses)")
    if missing:
        raise BenchError(f"the reference lacks what the harness uses: "
                         f"{missing}")
    return types.SimpleNamespace(**mods, proposals=proposals)


def reference_models(conf: dict, device) -> tuple:
    """(refs, cfg, detector, tracker): a configuration's reference modules
    (`reference_modules`), its reference `Config`, and its
    random-initialised detector and tracker on `device` (load the
    benchmark's weights into them)."""
    refs = reference_modules(conf)
    cfg = config_from_dict(refs.config.Config, conf["config"])
    det = refs.detector.MaskRCNN(cfg.detection, device=device)
    if not hasattr(det, "anchors"):
        raise BenchError(f"the reference lacks what the harness uses: "
                         f"{refs.detector.__name__}.MaskRCNN().anchors")
    return refs, cfg, det, refs.tracker.TrackerModel(cfg.graph, device=device)


def meta_models(conf: dict) -> tuple:
    """`reference_models` on the meta device: shapes, no data."""
    import torch
    with torch.device("meta"):
        return reference_models(conf, "meta")


def model_weights(conf: dict, seed: int, device):
    """(detector, tracker) state_dicts of a configuration from `seed`, made
    on the structure of its reference's models."""
    _, _, det, trk = meta_models(conf)
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


def end_processes(procs: list, timeout: float = 120.0) -> None:
    """Wait for each spawned process, killing one still alive after
    `timeout` s, then end multiprocessing's resource tracker, which
    spawning started, so that a run leaves no process behind."""
    from multiprocessing import resource_tracker
    for p in procs:
        p.join(timeout=timeout)
        if p.is_alive():
            p.kill()
            p.join()
    resource_tracker._resource_tracker._stop()


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
