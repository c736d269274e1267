"""The offline MOTFront workflow against the JAX package, on the CPU, on a
tiny fixture (64 x 64 camera, `__graft_entry__._tiny_config`):

  - the exporter in oracle mode, frame by frame, with JAX's RANSAC draws
    rebuilt from its key chain: per-slot metrics and the .h5 written;
  - `TrackingTrainer.train` for one epoch and `validate` against JAX's, on
    the same noisy synthetic sequences (the JAX package's generator) and
    permutation stream, in float64, the JAX trainer state carried into the
    port by `importers/flax_params.py:import_train_state`;
  - the trainers' mechanics (eval and checkpoint periods, best by
    val_total, resume equal to an uninterrupted run) and the CLI's five
    subcommands with `--device cpu`.

Tolerances.  Oracle export: classes and kept slots exact, poses and
metrics rtol = atol = 1e-4 (float32 on both sides), rotation errors atol
1e-2 degrees (arccos near 0 amplifies float32 rounding).  Tracking losses
and MOTA summaries rtol 1e-9; parameters rtol 1e-9, atol 1e-7: Adam's
update lr g / (|g| + eps) of an element whose gradient is near eps = 1e-8
turns a 1e-13 rounding of g into 1e-8 of the parameter per update
(ROADMAP.md Queue 3, "Adam's first step"), and the next steps' gradients
(the Adam first moments) then differ by up to 1e-6 of each leaf's
scale.  The detection trainer's parity
is in test_torch_port_detection_trainer.py.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mot3d_tpu.data.detection_loader import load_frame as load_frame_j
from mot3d_tpu.data.h5_io import read_frame_h5 as read_h5_j
from mot3d_tpu.data.motfront import MOTFrontDataset as DatasetJ
from mot3d_tpu.export import DetectorExporter as ExporterJ
from mot3d_tpu.models import mask_rcnn as mrcnn_j
from mot3d_tpu.train import tracking_trainer as trk_trainer_j
from mot3d_tpu_torch import cli
from mot3d_tpu_torch.config import Config
from mot3d_tpu_torch.data.detection_loader import load_frame, stack_samples
from mot3d_tpu_torch.data.fixtures import (write_motfront_fixture,
                                           write_office_fixture)
from mot3d_tpu_torch.data.h5_io import read_frame_h5
from mot3d_tpu_torch.data.motfront import MOTFrontDataset
from mot3d_tpu_torch.export import DetectorExporter
from mot3d_tpu_torch.importers.flax_params import (import_train_state,
                                                   tracker_state_dict)
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
from mot3d_tpu_torch.train.detection_trainer import DetectionTrainer
from mot3d_tpu_torch.train.tracking_trainer import TrackingTrainer
from test_torch_port_visualise import _assert_same_tree
from torch_port_helpers import port_config, slot_draws

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
f64 = functools.partial(jax.tree_util.tree_map,
                        lambda a: np.asarray(a, np.float64))
SPLITS = {"train": (3, 3), "val": (1, 3), "test": (1, 3)}


def _tiny():
    cfg = _tiny_config()
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, seq_len=3, batch_size=1))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("motfront")
    cam = _tiny().camera
    for seed, (split, (n, t)) in enumerate(SPLITS.items()):
        write_motfront_fixture(str(path), split, num_scenes=n, num_frames=t,
                               num_objects=3, seed=seed + 1, cam=cam,
                               camera_dist=2.6, half_range=(0.35, 0.6))
    return str(path)


def _close(got, want, rtol=1e-4, atol=1e-4, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


# ----------------------------------------------------------- the exporter


def _jax_keys(n):
    """The per-frame keys of the JAX exporter's split walk."""
    rng, keys = jax.random.PRNGKey(0), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    return keys


def test_oracle_export_frame_matches_jax(root, tmp_path):
    """Every frame of two splits through both exporters in oracle mode:
    equal kept slots and classes, metrics and poses to 1e-4, and the .h5
    each writes reads back equal (GT fields exactly)."""
    cfg = _tiny()
    cfg_t = port_config(cfg)
    ex_j = ExporterJ(cfg, mrcnn_j.MaskRCNN(cfg.detection), None)
    ex_t = DetectorExporter(cfg_t, MaskRCNN(cfg_t.detection, device="cpu"),
                            device="cpu")
    p, kept = cfg.pose, 0
    for split in ("val", "test"):
        ds_j, ds_t = DatasetJ(root, split), MOTFrontDataset(root, split)
        frames = ds_t.load_scene(ds_t.scenes()[0]).frames
        for t, (fr, key) in enumerate(zip(frames, _jax_keys(len(frames)))):
            s_j = load_frame_j(ds_j, ds_j.load_scene(ds_j.scenes()[0])
                               .frames[t], cfg.detection)
            s_t = load_frame(ds_t, fr, cfg_t.detection)
            m_j = ex_j.export_frame(s_j, str(tmp_path / "j" / f"{t}.h5"),
                                    key, oracle=True)
            draws = slot_draws(key, cfg.detection.max_instances,
                               p.ransac_iters, p.ransac_sample_size)
            m_t = ex_t.export_frame(s_t, str(tmp_path / "t" / f"{t}.h5"),
                                    torch.from_numpy(draws), oracle=True)
            assert m_t["classes"] == m_j["classes"]
            _close(m_t["voxel_iou"], m_j["voxel_iou"], what="voxel_iou")
            _close(m_t["loc_err"], m_j["loc_err"], what="loc_err")
            # arccos near 0 amplifies float32 rounding: 1e-2 degrees.
            _close(m_t["rot_err"], m_j["rot_err"], atol=1e-2, what="rot")
            h_t = read_frame_h5(str(tmp_path / "t" / f"{t}.h5"))
            h_j = read_h5_j(str(tmp_path / "j" / f"{t}.h5"))
            for name, a, b in zip(h_j._fields, h_t, h_j):
                if name in ("classes",) or name.startswith("gt_") and \
                        name != "gt_boxes":
                    np.testing.assert_array_equal(a, b, err_msg=name)
                else:
                    _close(a, b, what=name)
            kept += len(m_t["classes"])
    assert kept >= 6
    assert all(v == 1.0 for v in m_t["voxel_iou"])


# -------------------------------------------------- the detection trainer


# ------------------------------------------------------------ mechanics


def _frames(root, split, cfg_t):
    ds = MOTFrontDataset(root, split)
    return [load_frame(ds, fr, cfg_t.detection)
            for s in ds.scenes() for fr in ds.load_scene(s).frames]


def test_detection_trainer_periods_best_and_resume(root, tmp_path):
    """eval_period 2 and checkpoint_period 2 over 3 steps: one eval (val
    losses only), best by val_total, checkpoint at 2; a resumed trainer's
    third step equals an uninterrupted run's (draws from (seed, step))."""
    cfg = _tiny()
    cfg_t = port_config(cfg.replace(combined=dataclasses.replace(
        cfg.combined, eval_period=2, checkpoint_period=2)))
    frames = _frames(root, "train", cfg_t)
    batches = [stack_samples(frames[i:i + 2]) for i in range(0, 6, 2)]
    val = [stack_samples(_frames(root, "val", cfg_t))]

    a = DetectionTrainer(cfg_t, str(tmp_path / "a"), device="cpu")
    a.train(iter(batches[:2]), val, max_iter=2, full_eval=False)
    assert a.ckpt.all_steps() == [2] and a.ckpt.best["val_loss"]["step"] == 2
    b = DetectionTrainer(cfg_t, str(tmp_path / "a"), device="cpu")
    b.train(iter(batches[2:]), max_iter=3, resume=True)
    c = DetectionTrainer(cfg_t, str(tmp_path / "c"), device="cpu")
    c.train(iter(batches), val, max_iter=3, full_eval=False)
    assert b.state.step == c.state.step == 3
    sb, sc = b.state.state_dict(), c.state.state_dict()
    for k, v in sc["model"].items():
        assert torch.equal(sb["model"][k], v), k
    for i, st in sc["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(sb["optimizer"]["state"][i][k], v)
    lines = open(tmp_path / "c" / "metrics.jsonl").read().splitlines()
    assert sum('"val"' in ln for ln in lines) == 1


# -------------------------------------------------- the tracking trainer


def _synthetic(cfg, n, seed0):
    """JAX's synthetic noisy sequences (drops, false positives), as dicts
    of numpy arrays."""
    from mot3d_tpu.data.synthetic import synthetic_sequence
    return [{k: np.asarray(v) for k, v in synthetic_sequence(
        cfg.tracking, seed=seed0 + i, num_objects=3, noise=0.01)
        ._asdict().items()} for i in range(n)]


def test_tracking_trainer_epoch_and_validate_match_jax(tmp_path):
    """One epoch over three sequences (batch 1, the seeded permutation
    stream) and validation, from the same initial state carried over from
    JAX's trainer: equal losses, parameters and MOTA summary; then
    `inference(export_dir=...)` writes the same file tree, byte for byte,
    as JAX's `validate(export_dir=...)`."""
    cfg = _tiny()
    seqs = {"train": _synthetic(cfg, 3, 0), "val": _synthetic(cfg, 2, 100)}
    with jax.enable_x64(True):
        tj = trk_trainer_j.TrackingTrainer(cfg, str(tmp_path / "j"))
        tj.init_state(None)
        p64 = f64(jax.device_get(tj.state.params))
        opt0 = tj.optimizer.init(p64)
        tj.state = tj.state._replace(params=p64, opt_state=opt0)
        res_j = tj.train(seqs["train"], seqs["val"], num_epochs=1)
        state_j = jax.device_get(tj.state)
        opt0 = jax.device_get(opt0)
        vis_j = tj.validate(seqs["val"], classwise=True,
                            export_dir=str(tmp_path / "vis_j"))

    tt = TrackingTrainer(port_config(cfg), str(tmp_path / "t"),
                         device="cpu")
    tt.model.double()
    tt.init_state()
    import_train_state((p64, opt0, 0), tt.state)
    res_t = tt.train(seqs["train"], seqs["val"], num_epochs=1)
    assert tt.state.step == int(state_j.step) == 3
    assert sorted(res_t) == sorted(res_j)
    for k, v in res_j.items():
        assert res_t[k] == pytest.approx(float(v), rel=1e-9, abs=1e-12), k
    assert res_t["val_loss"] > 0
    want = tracker_state_dict(state_j.params, port_config(cfg))
    mu = tracker_state_dict(state_j.opt_state[0].mu, port_config(cfg))
    opt = tt.state.optimizer.state_dict()["state"]
    for i, (name, p) in enumerate(tt.model.named_parameters()):
        scale = float(np.abs(mu[name].numpy()).max())
        _close(opt[i]["exp_avg"], mu[name], rtol=1e-9, atol=1e-6 * scale,
               what=name)
        _close(p.detach(), want[name], rtol=1e-9, atol=1e-7, what=name)
    res_vis = tt.inference(seqs["val"], export_dir=str(tmp_path / "vis"))
    assert {k: res_vis[k] for k in res_t} == res_t
    for k, v in vis_j.items():
        assert res_vis[k] == pytest.approx(float(v), rel=1e-9, abs=1e-12), k
    _assert_same_tree(tmp_path / "vis", tmp_path / "vis_j")
    for i in range(len(seqs["val"])):
        assert (tmp_path / "vis" / f"seq_{i:03d}" / "replay.html").exists()


# ----------------------------------------------------------------- CLI


def _overrides(cfg: Config):
    """`section.field=value` strings for every field that differs from the
    default config."""
    out, default = [], Config()
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(default, f.name)
        for g in dataclasses.fields(a):
            v = getattr(a, g.name)
            if v != getattr(b, g.name):
                v = ",".join(map(str, v)) if isinstance(v, tuple) else v
                out.append(f"{f.name}.{g.name}={v}")
    return out


def test_cli_runs_the_workflow_on_the_cpu(root, tmp_path, capsys):
    """train-detection -> export-detections (a subprocess of
    `python -m mot3d_tpu_torch.cli`, oracle) -> train-tracking ->
    infer-tracking (also with --export-vis) -> train-combined, with
    --device cpu and tiny overrides, then infer-office with the trained
    detector's checkpoint on an office tree; without a checkpoint
    infer-tracking refuses random weights."""
    cfg = _tiny()
    ov = _overrides(port_config(cfg.replace(
        combined=dataclasses.replace(cfg.combined, checkpoint_period=1),
        tracking=dataclasses.replace(cfg.tracking, num_epochs=1))))
    out = tmp_path
    dev = ["--device", "cpu"]
    cli.main(["train-detection", "--data", root, "--out", str(out / "det"),
              "--max-iter", "1", "--cache-samples", "4", *dev, *ov])
    assert os.path.exists(out / "det" / "ckpt" / "step_1.pt")
    res = subprocess.run(
        [sys.executable, "-m", "mot3d_tpu_torch.cli", "export-detections",
         "--data", root, "--split", "train", "--out", str(out / "h5" / "tr"),
         "--oracle", "--ckpt", str(out / "det"), *dev, *ov],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "restored checkpoint at step 1" in res.stdout
    assert "/voxel_iou': 1.0" in res.stdout
    for split in ("val", "test"):
        cli.main(["export-detections", "--data", root, "--split", split,
                  "--out", str(out / "h5" / split), "--oracle", *dev, *ov])
    with pytest.raises(SystemExit, match="random weights"):
        cli.main(["infer-tracking", "--data", str(out / "h5" / "test"),
                  "--ckpt", str(out / "none"), *dev, *ov])
    cli.main(["train-tracking", "--data", str(out / "h5" / "tr"),
              "--val-data", str(out / "h5" / "val"), "--out",
              str(out / "trk"), *dev, *ov])
    capsys.readouterr()
    cli.main(["infer-tracking", "--data", str(out / "h5" / "test"),
              "--ckpt", str(out / "trk"), "--out", str(out / "ev"), *dev,
              *ov])
    assert "restored best-mota checkpoint" in capsys.readouterr().out
    cli.main(["infer-tracking", "--data", str(out / "h5" / "test"),
              "--ckpt", str(out / "trk"), "--out", str(out / "ev"),
              "--export-vis", *dev, *ov])
    assert (out / "ev" / "vis" / "seq_000" / "replay.html").exists()
    cli.main(["train-combined", "--data", root, "--out", str(out / "comb"),
              "--max-iter", "1", "--det-ckpt", str(out / "det"), *dev, *ov])
    assert os.path.exists(out / "comb" / "ckpt" / "step_1.pt")
    write_office_fixture(str(out / "office"), num_scenes=1, num_frames=2,
                         hw=(96, 128))
    capsys.readouterr()
    cli.main(["infer-office", "--data", str(out / "office"), "--ckpt",
              str(out / "det"), "--out", str(out / "office_out"),
              "--max-frames", "1", *dev, *ov])
    assert "restored checkpoint at step 1" in capsys.readouterr().out
    assert (out / "office_out" / "scene00" / "trajectories.json").exists()
