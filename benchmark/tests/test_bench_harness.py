"""The harness is driven by data, prints the result line the contract
asks for, and refuses to run without a card."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import common, profiling, run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _tree_hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_bench_new_cell_config_and_metric_are_found_from_files(tmp_path):
    """A later change adds a configuration, a cell and a per-layer metric
    as new files plus new entries; the harness finds them by name and no
    file it already had is edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / d, tmp_path / "benchmark" / d)
    before = _tree_hashes(tmp_path / "benchmark")
    conf = json.loads((BENCH / "configs" / "r50fpn-gn.json").read_text())
    conf["name"] = "r50fpn-gn-wide"
    (tmp_path / "benchmark/configs/r50fpn-gn-wide.json").write_text(
        json.dumps(conf))
    (tmp_path / "benchmark/workloads/serve.wide.c4.json").write_text(
        json.dumps({"check": {"first_calls": 6, "per_client": 2},
                    "limits": {"edge_gap": 1e-6}}))
    (tmp_path / "benchmark/metrics/answer.serve.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "r50fpn-gn-wide", "source": "x",
                             "file": "benchmark/configs/r50fpn-gn-wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "serve.wide.c4",
                               "config": "r50fpn-gn-wide",
                               "traffic": "seq25.c4", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "answer.serve", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "frames_per_s",
                               "workloads": ["serve.wide.c4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = common.cell("serve.wide.c4", root=tmp_path)
    assert c["config"]["name"] == "r50fpn-gn-wide"
    assert c["traffic"]["kind"] == "sequences"
    assert c["workload"]["limits"] == {"edge_gap": 1e-6}
    names = [m["name"] for m in c["per_layer"]]
    assert names == ["answer.serve"]
    read = common.readers(c["per_layer"], c["metrics_dir"])
    assert read["answer.serve"]({}) == 42.0
    old = common.cell("serve.gn.c4", root=tmp_path)
    assert "answer.serve" not in [m["name"] for m in old["per_layer"]]
    after = _tree_hashes(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before


TOY_RUN = """
import json, sys
from pathlib import Path
root = Path({root!r})
sys.path.insert(0, str(root))
import torch
from benchmark import common, compare, counts
from benchmark.reference import steps
from benchmark.tests.tiny import tiny_config

c = common.cell("serve.toy.c4", root=root)
conf = c["config"]
refs, cfg, det, _ = common.meta_models(conf)
w_det, _ = common.model_weights(conf, {seed}, "cpu")
gen = torch.Generator().manual_seed({seed})
n = sum(p.numel() for p in det.parameters())
torch.rand(n, generator=gen)
nrm = torch.randn(n, generator=gen)
ref = compare.Reference(conf, {seed}, "cpu")
images = torch.rand((2, 64, 64, 3), generator=gen) * 255
out = steps.detect(ref.det, images, "cpu")
base = tiny_config("r50fpn-gn")
print(json.dumps({{
    "files": [m.__file__ for m in (refs.config, refs.detector, refs.tracker,
                                   common, sys.modules[type(det).__module__])],
    "detector": type(ref.det).__module__ + "." + type(ref.det).__name__,
    "eps": [cfg.detection.feature_norm_eps, ref.det.feature_norm.eps],
    "norm": [w_det["feature_norm.weight"].tolist(),
             w_det["feature_norm.bias"].tolist()],
    "mix_gap": float((w_det["feature_mix"]
                      - 0.02 * nrm[:64 * 64].view(64, 64)).abs().max()),
    "serve": [counts.serve_flops(conf), counts.serve_flops(base)],
    "train": [counts.train_flops(conf, 2), counts.train_flops(base, 2)],
    "boxes": list(out.boxes.shape)}}))
"""


def test_bench_new_architecture_is_added_by_new_files_only(tmp_path):
    """A configuration whose model differs in structure: its own reference
    `Config` (one more detection field), its own detector module (a
    LayerNorm and a bare parameter the reference lacks) and their weight
    rules, brought as new files and entries on a copy of the benchmark.
    In a process that imports the harness from that copy, the cell, the
    reference modules, the weights, the FLOP counts and the reference's
    forward all take them; no file the copy had is edited."""
    from benchmark.tests.tiny import tiny_config
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "toyref"))
    before = _tree_hashes(tmp_path / "benchmark")

    shutil.copytree(BENCH / "tests" / "toyref",
                    tmp_path / "benchmark/tests/toyref",
                    ignore=shutil.ignore_patterns("__pycache__"))
    conf = tiny_config("r50fpn-gn")
    conf.pop("flops")
    conf["name"] = "toy-ln"
    conf["reference"] = {"config": "benchmark.tests.toyref.config",
                         "detector": "benchmark.tests.toyref.detector"}
    conf["config"]["detection"]["feature_norm_eps"] = 1e-5
    conf["weights"]["detector"]["normal"] = {"feature_mix": 0.02}
    (tmp_path / "benchmark/configs/toy-ln.json").write_text(json.dumps(conf))
    shutil.copy(BENCH / "workloads/serve.gn.c4.json",
                tmp_path / "benchmark/workloads/serve.toy.c4.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-ln", "source": "x",
                             "file": "benchmark/configs/toy-ln.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "serve.toy.c4", "config": "toy-ln",
                               "traffic": "seq25.c4", "chips": 1,
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    seed = 2 ** 33 + 5
    out = subprocess.run(
        [sys.executable, "-c", TOY_RUN.format(root=str(tmp_path), seed=seed)],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "USE_FLAX": "0", "PYTHONDONTWRITEBYTECODE": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for f in got["files"]:
        assert Path(f).is_relative_to(tmp_path), f
    assert got["detector"] == "benchmark.tests.toyref.detector.MaskRCNN"
    assert got["eps"] == [1e-5, 1e-5]
    assert got["norm"] == [[1.0] * 64, [0.0] * 64]
    assert got["mix_gap"] == 0.0
    # The bare 64 x 64 matrix on P2 (16 x 16 at 64 x 64) of each frame:
    # once serving 2 frames; forward and its two gradients training 2.
    mix = 2 * 2 * 16 * 16 * 64 * 64
    assert got["serve"][0] - got["serve"][1] == mix
    assert got["train"][0] - got["train"][1] == 3 * mix
    assert got["boxes"] == [2, 4, 4]
    after = _tree_hashes(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "configs/toy-ln.json", "workloads/serve.toy.c4.json",
        *(f"tests/toyref/{f.name}" for f in
          (BENCH / "tests" / "toyref").glob("*.py"))}


def _fake_summary():
    return {"kernels": {"knn_mean_dists_kernel<5>": [2, 1e-4],
                        "gemm": [10, 2e-3]},
            "copies": {"Memcpy HtoD": [1, 1e-4]}, "calls": 2,
            "device": np.array([[0.0, 100.0], [150.0, 400.0]]),
            "host": (np.array([0.0, 120.0]), np.array([500.0, 130.0]),
                     np.array([0, 1], np.int32), ["detect", "aten::copy_"]),
            "labels": ["detect"], "span": (0.0, 500.0),
            "stage_s": {"detect": 0.5, "pose": 0.1, "track": 0.1},
            "stage_calls": 2}


@pytest.mark.parametrize("trace", [0, 1])
def test_bench_result_line_has_the_contract_keys(trace):
    c = common.cell("serve.gn.c4")
    res = {"attempted": 10, "memory_peak_bytes": 123, "frames_per_s": 200.0,
           "seq_p95_ms": 500.0, "setup_s": 25.0, "plain_rate": 8.0,
           "results": [{"trace": _fake_summary()}],
           "solo": {"kernels": {"knn_mean_dists_kernel<5>": [6, 3e-4],
                                "gemm": [30, 6e-3]}, "calls": 3,
                    "work": {"k1": {"calls": 6, "ops": 1e9, "bytes": 1e6},
                             "k3": {"calls": 0, "ops": 0.0, "bytes": 0.0}}}}
    readings = {k: 0.0 for k in c["workload"]["limits"]}
    readings["posed_per_sequence"] = 400.0
    ident = {"kind": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    args = type("A", (), {"trace": trace})()
    line = run.result_line(c, args, res, readings, ident)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert line["correct"] is True
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 123
    if trace:
        assert "breakdown" in line
        assert dev["window_s"] == pytest.approx(500e-6)
        assert dev["busy_s"] == pytest.approx(350e-6)
        assert line["breakdown"]["idle_gaps"] == [
            ["detect:no op", pytest.approx(100e-6)],
            ["detect:aten::copy_", pytest.approx(50e-6)]]
        assert set(line["metrics"]) <= {m["name"] for m in c["per_layer"]}
        assert line["metrics"]["device_idle.serve"]["value"] == \
            pytest.approx(30.0)
        assert line["metrics"]["launches_per_seq.serve"]["value"] == 6.0
        # K1 is read from the calls profiled alone; K3 ran in none.
        from benchmark.counts import bound_s
        assert line["metrics"]["k1_roofline.serve"]["value"] == \
            pytest.approx(bound_s(1e9, 1e6) / 3e-4 * 100.0)
        assert "k3_roofline.serve" not in line["metrics"]
    else:
        assert "breakdown" not in line
        assert set(line["metrics"]) == {"frames_per_s", "seq_p95_ms",
                                        "setup_s"}
    json.dumps(line)


def test_bench_merge_takes_the_union_over_processes():
    a, b = _fake_summary(), _fake_summary()
    b["device"] = np.array([[50.0, 200.0]])
    merged = profiling.merge([a, b])
    assert merged["busy_s"] == pytest.approx(400e-6)
    assert merged["window_s"] == pytest.approx(500e-6)
    assert merged["calls"] == 4


def test_bench_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve.gn.c4", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_bench_refuses_to_run_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve.gn.c4", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bench_data_parallel_result_line_reads_each_card_alone():
    """Four ranks' profiles: busy and window seconds per card, averaged,
    never their union; kernels, launches and NCCL time the first rank's;
    the card count is the ranks'."""
    c = common.cell("train.det.gn.dp4")
    cards = []
    for r in range(4):
        s = _fake_summary()
        s["kernels"] = {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": [2, 4e-3],
                        "gemm": [10, 2e-3]}
        s["labels"] = ["step"]
        s["device"] = np.array([[0.0, 100.0 * (r + 1)]])
        cards.append(s)
    res = {"attempted": 10, "memory_peak_bytes": 123, "setup_s": 30.0,
           "train_images_per_s": 80.0, "plain_rate": 10.0, "cards": 4,
           "trace": cards[0], "card_traces": cards}
    readings = {k: 0.0 for k in c["workload"]["limits"]}
    ident = {"kind": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    line = run.result_line(c, type("A", (), {"trace": 1})(), res, readings,
                           ident)
    assert line["correct"] is True
    assert line["device"]["count"] == 4
    assert line["device"]["window_s"] == pytest.approx(500e-6)
    assert line["device"]["busy_s"] == pytest.approx(250e-6)
    m = line["metrics"]
    assert m["allreduce_ms.train"]["value"] == pytest.approx(2.0)
    assert m["launches_per_step.train"]["value"] == 6.0
    assert m["device_idle.train"]["value"] == pytest.approx(50.0)
    assert set(m) == {"mfu.train", "launches_per_step.train",
                      "device_idle.train", "allreduce_ms.train"}
    plain = run.result_line(c, type("A", (), {"trace": 0})(), res, readings,
                            ident)
    assert set(plain["metrics"]) == {"train_images_per_s", "setup_s"}
    assert "replica_gap" in plain["compared"]
