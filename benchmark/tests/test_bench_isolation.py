"""No process of the benchmark loads JAX or the JAX package, and the
plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.common import FORBIDDEN, REFERENCE, reference_sources

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

EXERCISE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.bench_helpers import serve_run, train_run, train_dp_run
from benchmark import common
serve_run(clients=1, seconds=0.5)
train_run()
train_dp_run(seconds=0.5)
print(json.dumps(sorted(sys.modules)))
"""


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_bench_exercise_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", EXERCISE.format(
        root=str(ROOT))], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                       "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    loaded = sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
    assert loaded == []
    assert any(m.split(".")[0] == "mot3d_tpu_torch" for m in modules)


def _reference_roots() -> list:
    """The modules each configuration's reference names, the defaults
    where it names none, and the toy reference's."""
    confs = [json.loads(f.read_text())
             for f in sorted((BENCH / "configs").glob("*.json"))]
    confs.append({"reference": {
        "config": "benchmark.tests.toyref.config",
        "detector": "benchmark.tests.toyref.detector"}})
    return sorted({m for c in confs
                   for m in {**REFERENCE, **c.get("reference", {})}.values()})


def test_bench_reference_imports_nothing_of_the_program():
    """Every file under `reference/`, and every module that a
    configuration's reference names or reaches through modules under
    `benchmark.` at any depth, wherever it lies."""
    files = {f: _imports(f)
             for f in sorted((BENCH / "reference").rglob("*.py"))}
    reached = {Path(f).resolve(): names for f, names in
               reference_sources(_reference_roots()).items()}
    assert BENCH / "reference/models/resnet_fpn.py" in reached
    assert BENCH / "reference/dp_steps.py" in files
    assert BENCH / "tests/toyref/detector.py" in reached
    files.update(reached)
    for f, names in files.items():
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"mot3d_tpu_torch", *FORBIDDEN}, f


def test_bench_no_file_imports_jax():
    for f in sorted(BENCH.rglob("*.py")):
        tops = {n.split(".")[0] for n in _imports(f)}
        assert not tops & set(FORBIDDEN), f
