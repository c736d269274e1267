"""No process of the benchmark loads JAX or the JAX package, and the
plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.common import FORBIDDEN

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

EXERCISE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.bench_helpers import serve_run, train_run
from benchmark import common
serve_run(clients=1, seconds=0.5)
train_run()
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


def test_bench_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        tops = {n.split(".")[0] for n in _imports(f)}
        assert not tops & {"mot3d_tpu_torch", *FORBIDDEN}, f


def test_bench_no_file_imports_jax():
    for f in sorted(BENCH.rglob("*.py")):
        tops = {n.split(".")[0] for n in _imports(f)}
        assert not tops & set(FORBIDDEN), f
