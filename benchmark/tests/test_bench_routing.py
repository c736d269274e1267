"""How a configuration reaches the harness: its reference `Config` parsed
strictly and the program's with the class defaults for what the file
omits, the reference modules it names, and the weight rules.  The
configurations the benchmark has resolve, and make their weights, exactly
as they did before a configuration could name its own reference."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import sys
from pathlib import Path

import pytest
import torch
from torch import nn

from benchmark import common

BENCH = Path(__file__).resolve().parents[1]
SEED = 12_345_678_901
# sha256 of the (detector, tracker) state_dicts from SEED on the CPU
# (`_digest`), recorded before configurations named their references.
DIGESTS = {
    "r50fpn-gn": ("bbaa5db6f586271af62caf03c29ee4e8"
                  "02989008ba9d320d2fc53c1a1f0ed961"),
    "r50fpn-d2": ("7265915b4a2883d72b19932cd5524de1"
                  "7ebb9a179ac284a5c4d4818bf24e9214"),
    "tracker": ("887ca030365e3d2decf7d7fd05000435"
                "02526fde9e9deb2f7d94110680a96e92"),
}


def _conf(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        v = state[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(str(v.dtype).encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def _as_json(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


@pytest.mark.parametrize("name", ["r50fpn-gn", "r50fpn-d2"])
def test_bench_existing_configs_resolve_as_before(name, capsys):
    """No `reference` key: the default modules; both `Config`s hold
    exactly the file's fields, and the program's takes no default."""
    conf = _conf(name)
    assert "reference" not in conf
    refs = common.reference_modules(conf)
    assert {role: getattr(refs, role).__name__ for role in common.REFERENCE
            } == common.REFERENCE
    assert refs.proposals is refs.detector
    _, cfg, _, _ = common.meta_models(conf)
    assert type(cfg) is refs.config.Config
    assert _as_json(cfg) == conf["config"]
    assert _as_json(common.program_config(conf["config"], say=True)) == \
        conf["config"]
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("name", ["r50fpn-gn", "r50fpn-d2"])
def test_bench_existing_weights_hash_as_before(name):
    det, trk = common.model_weights(_conf(name), SEED, "cpu")
    assert _digest(det) == DIGESTS[name]
    assert _digest(trk) == DIGESTS["tracker"]


def test_bench_program_config_fills_an_omitted_field_with_its_default(
        capsys):
    from mot3d_tpu_torch.config import Config
    data = json.loads(json.dumps(_conf("r50fpn-gn")["config"]))
    assert data["detection"].pop("score_thresh_test") != \
        Config().detection.score_thresh_test
    cfg = common.program_config(data, say=True)
    assert cfg.detection.score_thresh_test == \
        Config().detection.score_thresh_test
    assert cfg.detection.fast_nms == data["detection"]["fast_nms"]
    err = capsys.readouterr().err
    assert "detection.score_thresh_test" in err
    assert err.count("\n") == 1
    common.program_config(data)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("where", ["field", "section"])
@pytest.mark.parametrize("side", ["program", "reference"])
def test_bench_config_refuses_unknown_fields(where, side):
    from benchmark.reference.config import Config as RefConfig
    data = json.loads(json.dumps(_conf("r50fpn-gn")["config"]))
    if where == "field":
        data["detection"]["backbone_kind"] = "vit"
    else:
        data["vision"] = {}
    with pytest.raises(common.BenchError,
                       match="backbone_kind" if where == "field"
                       else "vision"):
        if side == "program":
            common.program_config(data)
        else:
            common.config_from_dict(RefConfig, data)


def test_bench_reference_config_refuses_a_missing_field():
    from benchmark.reference.config import Config as RefConfig
    data = json.loads(json.dumps(_conf("r50fpn-gn")["config"]))
    del data["pose"]["max_points"]
    with pytest.raises(common.BenchError, match="pose.max_points"):
        common.config_from_dict(RefConfig, data)


class LayerNorm(nn.Module):
    """A channel LayerNorm of a reference's own, as detectron2's is: not
    torch's class, but named as it is."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))


class _Scale(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))


class _Model(nn.Module):
    def __init__(self, scale=False):
        super().__init__()
        self.pos = nn.Parameter(torch.empty((2, 3)))
        self.lin = nn.Linear(3, 4)
        self.ln = nn.LayerNorm(4)
        self.unit = LayerNorm(4)
        if scale:
            self.scale = _Scale(4)


def test_bench_weight_rules_take_each_parameter_at_its_offset():
    """`pos` (a bare parameter) by a `normal` pattern, torch's LayerNorm
    and a reference's own class named LayerNorm at 1 and 0, the linear
    layer by its fan-in; a pattern ahead of a module's rule; every draw
    read at the parameter's own offset."""
    model = _Model()
    rules = {"normal": {"pos": 0.5}}
    w = common.make_weights(model, SEED, rules, "cpu")
    gen = torch.Generator().manual_seed(SEED % 2 ** 63)
    uni = torch.rand(38, generator=gen) * 2.0 - 1.0
    nrm = torch.randn(38, generator=gen)
    assert torch.equal(w["pos"], 0.5 * nrm[:6].view(2, 3))
    assert torch.equal(w["lin.weight"], uni[6:18].view(4, 3) / 3 ** 0.5)
    assert torch.equal(w["lin.bias"], uni[18:22] / 3 ** 0.5)
    for norm in ("ln", "unit"):
        assert torch.equal(w[f"{norm}.weight"], torch.ones(4))
        assert torch.equal(w[f"{norm}.bias"], torch.zeros(4))
    ahead = common.make_weights(
        model, SEED, {"normal": {"pos": 0.5, "lin.*": 0.1}}, "cpu")
    assert torch.equal(ahead["lin.weight"], 0.1 * nrm[6:18].view(4, 3))
    assert torch.equal(ahead["pos"], w["pos"])


@pytest.mark.parametrize("scale,rules,name", [
    (False, {}, "pos"),
    (True, {"normal": {"pos": 0.5}}, "scale.weight"),
])
def test_bench_weight_rules_refuse_a_parameter_without_one(scale, rules,
                                                           name):
    """A bare parameter with no pattern, and a module's 1-D weight that
    gives no fan-in and whose class is no unit norm."""
    with pytest.raises(common.BenchError, match=f"'{name}'"):
        common.make_weights(_Model(scale), SEED, rules, "cpu")


TOY = "benchmark.tests.toyref"


@pytest.mark.parametrize("role,module,missing", [
    ("config", f"{TOY}.detector", f"{TOY}.detector.Config"),
    ("detector", f"{TOY}.config",
     f"{TOY}.config.MaskRCNN', '{TOY}.config.DetectionDraws', "
     f"'{TOY}.config.GroundTruth"),
    ("tracker", f"{TOY}.detector", f"{TOY}.detector.TrackerModel"),
])
def test_bench_reference_module_lacking_a_name_is_refused(role, module,
                                                          missing):
    conf = {**_conf("r50fpn-gn"), "reference": {role: module}}
    with pytest.raises(common.BenchError, match=missing):
        common.reference_modules(conf)


@pytest.mark.parametrize("reference,match", [
    ({"backbone": "benchmark.reference.config"}, "backbone"),
    ({"config": "json"}, "'json'"),
    ({"tracker": "benchmark.nowhere"}, "benchmark.nowhere"),
])
def test_bench_reference_names_are_checked(reference, match):
    conf = {**_conf("r50fpn-gn"), "reference": reference}
    with pytest.raises(common.BenchError, match=match):
        common.reference_modules(conf)


@pytest.mark.parametrize("via", ["itself", "a module it imports"])
def test_bench_reference_importing_the_program_is_refused(via, tmp_path,
                                                          monkeypatch):
    """A reference module that imports the program, in its own source or
    through a module under `benchmark.` it imports inside a function, is
    refused by its file before it runs."""
    import benchmark.tests as pkg
    (tmp_path / "badhelper.py").write_text(
        "import mot3d_tpu_torch.config\n")
    (tmp_path / "badref.py").write_text(
        "from benchmark.reference.config import *  # noqa: F403\n" + (
            "from mot3d_tpu_torch.config import Config\n" if via == "itself"
            else "def make():\n    from benchmark.tests.badhelper import x\n"))
    monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(tmp_path)])
    importlib.invalidate_caches()
    conf = {**_conf("r50fpn-gn"),
            "reference": {"config": "benchmark.tests.badref"}}
    with pytest.raises(common.BenchError, match="mot3d_tpu_torch") as e:
        common.reference_modules(conf)
    culprit = "badref.py" if via == "itself" else "badhelper.py"
    assert str(tmp_path / culprit) in str(e.value)
    assert "benchmark.tests.badref" not in sys.modules
    assert "benchmark.tests.badhelper" not in sys.modules
