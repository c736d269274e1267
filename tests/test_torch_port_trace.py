"""The program's recorder (`mot3d_tpu_torch/utils/trace.py`) on the CPU:
off it records nothing and hands out one shared no-op; on, spans nest,
carry counters, and share the torch profiler's clock; the
serving step, the detection trainer and the office path record their
spans, and return the same bits with the recorder on and off.

The models are the tiny configuration of the port's dry run
(`parallel/dryrun.py`: 64 x 64 frames, a quarter-width backbone, 2-frame
sequences of 4 detections) with every gate open, on random weights."""

import contextlib

import numpy as np
import pytest
import torch

from mot3d_tpu_torch.data.detection_loader import DetectionSample
from mot3d_tpu_torch.data.fixtures import write_office_fixture
from mot3d_tpu_torch.data.office import OfficeDataset, office_inference
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
from mot3d_tpu_torch.models.mpn import TrackerModel
from mot3d_tpu_torch.parallel import infer_step
from mot3d_tpu_torch.parallel.dryrun import (dryrun_batch, open_gates,
                                             tiny_config)
from mot3d_tpu_torch.parallel.infer_step import (SequenceBatch,
                                                 make_sequence_infer_step,
                                                 outputs_to_host)
from mot3d_tpu_torch.tracking.graph_builder import make_template
from mot3d_tpu_torch.train.detection_trainer import DetectionTrainer
from mot3d_tpu_torch.utils import trace

torch.set_num_threads(1)

DETECT = ["detect.backbone", "detect.rpn", "detect.box", "detect.heads"]
TRAIN = ["train.upload", "train.forward", "train.backward",
         "train.optimizer"]


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@contextlib.contextmanager
def recording(records: list):
    """The recorder on inside the block; its records appended to
    `records` at the end."""
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        records.extend(trace.drain())


def _by_id(records):
    return {r["id"]: r for r in records}


def _root(by_id, r):
    """The outermost span that `r` lies in (`r` itself when it has no
    parent)."""
    while r["parent"] is not None:
        r = by_id[r["parent"]]
    return r


def _children(records, parent):
    return [r["name"] for r in sorted(records, key=lambda r: r["start_ns"])
            if r["parent"] == parent["id"]]


# ------------------------------------------------------------- recorder

@pytest.mark.parametrize("case", ["off", "nesting", "count", "clock"])
def test_recorder(case):
    if case == "off":
        a, b = trace.span("a"), trace.span("b")
        assert a is b
        with a:
            trace.count("n", 3)
        assert trace.drain() == []
    elif case == "nesting":
        rec = []
        with recording(rec):
            for _ in range(2):
                with trace.span("sequence"):
                    with trace.span("detect"):
                        with trace.span("detect.rpn"):
                            pass
                    with trace.span("pose"):
                        pass
            with trace.span("outside"):
                pass
        by = _by_id(rec)
        roots = [r for r in rec if r["name"] == "sequence"]
        assert len(roots) == 2 and all(r["parent"] is None for r in roots)
        for r in rec:
            if r["parent"] is not None:
                parent = by[r["parent"]]
                assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                    <= parent["end_ns"]
        assert [by[r["parent"]]["name"] for r in rec
                if r["name"] == "detect.rpn"] == ["detect", "detect"]
        # Each sequence's spans lie in it, four a sequence.
        assert [sum(_root(by, r) is root for r in rec) for root in roots] \
            == [4, 4]
        # A span opened outside any other has no parent.
        (out,) = [r for r in rec if r["name"] == "outside"]
        assert out["parent"] is None
    elif case == "count":
        rec = []
        with recording(rec):
            with trace.span("outer"):
                trace.count("h2d_bytes", 5)
                with trace.span("inner"):
                    trace.count("h2d_bytes", 7)
                    trace.count("h2d_bytes", 1)
                    trace.count("frames", 2)
            trace.count("h2d_bytes", 100)     # no span open: dropped
        by_name = {r["name"]: r["counts"] for r in rec}
        assert by_name == {"inner": {"h2d_bytes": 8, "frames": 2},
                           "outer": {"h2d_bytes": 5}}
    else:
        from torch.profiler import ProfilerActivity, profile
        rec = []
        x = torch.ones(4096)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with recording(rec):
                with trace.span("add"):
                    x.add(1.0)
        (s,) = rec
        adds = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "aten::add"]
        assert adds
        for e in adds:
            assert s["start_ns"] <= e.start_ns() <= e.end_ns() <= \
                s["end_ns"]


# ------------------------------------------------------- the program

@pytest.fixture(scope="module")
def serving():
    """The tiny serving step and a batch of two sequences."""
    cfg = open_gates(tiny_config())
    torch.manual_seed(0)
    det = MaskRCNN(cfg.detection, device="cpu")
    trk = TrackerModel(cfg.graph, device="cpu")
    with torch.no_grad():
        det.mask_head.Conv_4.bias.fill_(3.0)
    d, t = cfg.detection, cfg.tracking
    step = make_sequence_infer_step(
        det, trk, make_template(t.seq_len, d.detections_per_image,
                                t.max_frame_dist), cfg, device="cpu")
    raw = dryrun_batch(cfg, 2, seed=1)
    batch = SequenceBatch(
        images=raw["images"], depth=raw["depth"], campose=raw["campose"],
        gt_boxes2d=raw["gt_boxes2d"], gt_valid2d=raw["gt_valid"],
        gt_boxes3d=raw["gt_boxes3d"], gt_boxes3d_cropped=raw["gt_boxes3d"],
        gt_ids=raw["gt_ids"], gt_valid=raw["gt_valid"])
    draws = step.make_draws(batch, torch.Generator().manual_seed(2))
    return step, batch, draws


def _serve(serving):
    step, batch, draws = serving
    return outputs_to_host(step(batch, draws=draws))


def test_serving_step_records_its_span_tree(serving):
    rec = []
    with recording(rec):
        _serve(serving)
    by = _by_id(rec)
    seqs = [r for r in rec if r["name"] == "sequence"]
    assert len(seqs) == 2
    for seq in seqs:
        assert seq["parent"] is None
        assert _children(rec, seq) == ["detect", "pose", "track"]
        stages = {r["name"]: r for r in rec if r["parent"] == seq["id"]}
        detect = [n for n in _children(rec, stages["detect"])
                  if n != "upload"]
        assert detect == DETECT
        for stage in ("detect", "pose", "track"):
            assert "upload" in _children(rec, stages[stage])
    uploads = [r for r in rec if r["name"] == "upload"]
    # images; gt 2D boxes and flags, depth, campose, cropped GT boxes and
    # the draws; GT boxes, identities and flags: ten a sequence.
    assert len(uploads) == 20
    # Every span lies in its sequence; ten uploads in each.
    assert all(_root(by, r)["name"] == "sequence" for r in rec)
    assert [sum(_root(by, u) is seq for u in uploads) for seq in seqs] \
        == [10, 10]
    # The CPU step copies nothing from host to device.
    assert all("h2d_bytes" not in u["counts"] for u in uploads)


@pytest.mark.parametrize("source", ["numpy", "tensor"])
def test_upload_counts_host_bytes(serving, monkeypatch, source):
    """`_tensor` counts the source's bytes where a host array goes to a
    CUDA device (the device check patched to say so)."""
    step = serving[0]
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    if source == "tensor":
        x = torch.from_numpy(x).double()
    monkeypatch.setattr(infer_step, "_h2d", lambda x, device: True)
    rec = []
    with recording(rec):
        got = step._tensor(x, torch.float32)
    assert torch.equal(got, torch.arange(24.0).reshape(2, 3, 4))
    (u,) = rec
    assert u["name"] == "upload"
    assert u["counts"] == {"h2d_bytes": 24 * x.itemsize if source == "numpy"
                           else 24 * 8}


def _trainer(cfg, out_dir):
    trainer = DetectionTrainer(cfg, str(out_dir), device="cpu")
    trainer.init_state()
    return trainer


@pytest.fixture(scope="module")
def training():
    """The tiny detection config, a batch of two frames and its draws."""
    cfg = open_gates(tiny_config())
    raw = dryrun_batch(cfg, 1, seed=5)
    m, (h, w) = cfg.detection.max_instances, (64, 64)
    batch = DetectionSample(
        image=raw["images"][0], depth=raw["depth"][0],
        campose=raw["campose"][0], boxes=raw["gt_boxes2d"][0],
        classes=raw["gt_classes"][0], valid=raw["gt_valid"][0],
        masks=raw["gt_masks"][0], voxels=raw["gt_voxels"][0],
        nocs=raw["gt_nocs"][0], boxes3d=raw["gt_boxes3d"][0],
        object_ids=raw["gt_ids"][0],
        locations=np.zeros((2, m, 3), np.float32),
        rotations=np.zeros((2, m, 3), np.float32),
        scales3d=np.ones((2, m), np.float32))
    assert batch.image.shape[1:3] == (h, w)
    draws = MaskRCNN(cfg.detection, device="cpu").make_draws(
        2, torch.Generator().manual_seed(6))
    return cfg, batch, draws


def test_train_step_records_its_phases_in_order(training, tmp_path):
    cfg, batch, draws = training
    trainer = _trainer(cfg, tmp_path)
    rec = []
    with recording(rec):
        for _ in range(2):
            trainer.train_step(batch, draws)
    assert [r["name"] for r in rec] == TRAIN * 2
    assert all(r["parent"] is None for r in rec)
    ends = [(r["start_ns"], r["end_ns"]) for r in rec]
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(ends, ends[1:]))


@pytest.fixture(scope="module")
def office(tmp_path_factory):
    """One office scene of two frames, read at 64 x 64, and the tiny
    detector."""
    root = str(tmp_path_factory.mktemp("office"))
    (scene,) = write_office_fixture(root, num_scenes=1, num_frames=2,
                                    seed=3, hw=(128, 128),
                                    intrinsics=(128.0, 128.0, 63.5, 63.5))
    cfg = open_gates(tiny_config())
    torch.manual_seed(7)
    model = MaskRCNN(cfg.detection, device="cpu")
    with torch.no_grad():
        model.mask_head.Conv_4.bias.fill_(3.0)
    return cfg, model, OfficeDataset(root, (64, 64)), scene


def _office(office, mode):
    cfg, model, ds, scene = office
    return office_inference(cfg, model, ds, scene, tracker=mode,
                            device="cpu",
                            generator=torch.Generator().manual_seed(8))


@pytest.mark.parametrize("mode", ["heuristic", "f2f"])
def test_office_inference_records_its_stages(office, mode):
    rec = []
    with recording(rec):
        _office(office, mode)
    stage = "office.pose" if mode == "heuristic" else "office.centres"
    office_spans = [r["name"] for r in rec if r["parent"] is None]
    assert office_spans == ["office.reader", "office.detector", stage] * 2 \
        + ["office.tracker"]
    for det in (r for r in rec if r["name"] == "office.detector"):
        assert _children(rec, det) == DETECT


def _same(a, b):
    """Equal to the bit: arrays, tensors, numbers and strings inside
    lists, tuples and dicts."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("path", ["serving", "training", "office"])
def test_outputs_are_the_same_with_the_recorder_on_and_off(
        path, request, tmp_path):
    if path == "serving":
        serving = request.getfixturevalue("serving")
        run = lambda: _serve(serving)        # noqa: E731
    elif path == "training":
        cfg, batch, draws = request.getfixturevalue("training")

        def run():
            trainer = _trainer(cfg, tmp_path)
            losses = trainer.train_step(batch, draws)
            return losses, dict(trainer.model.state_dict())
    else:
        office = request.getfixturevalue("office")
        run = lambda: _office(office, "heuristic")   # noqa: E731
    off = run()
    rec = []
    with recording(rec):
        on = run()
    assert rec
    _same(on, off)
