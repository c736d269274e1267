"""Command-line entry points (counterpart of `mot3d_tpu/cli.py`), the
reference's scripts:

    python -m mot3d_tpu_torch.cli train-detection   # Detection/train_net.py
    python -m mot3d_tpu_torch.cli train-combined    # Detection/train_combined.py
    python -m mot3d_tpu_torch.cli export-detections # Detection/inference_detector.py
    python -m mot3d_tpu_torch.cli train-tracking    # Tracking/train.py (--use_graph)
    python -m mot3d_tpu_torch.cli infer-tracking    # Tracking/inference.py
    python -m mot3d_tpu_torch.cli train-siamese     # Tracking/train.py (no graph)
    python -m mot3d_tpu_torch.cli infer-siamese     # Tracking/inference.py (no graph)
    python -m mot3d_tpu_torch.cli import-torch-ckpt # the reference's .pth weights
    python -m mot3d_tpu_torch.cli infer-office      # Detection/inference_office_dset.py

Every subcommand runs on the GPU unless given `--device cpu` (it raises
without a GPU otherwise).  Config overrides use `section.field=value`
(`config.apply_overrides`), e.g.

    ... train-tracking --data out/h5/train --val-data out/h5/val \\
        tracking.learning_rate=5e-4 run.seed=1

Checkpoints are the port's own (`train/checkpoints.py`, one `torch.save`
file per step); `--ckpt` takes a trainer's output dir or its `ckpt/`, and
`import-torch-ckpt` writes them from the reference's torch checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List

from mot3d_tpu_torch.config import Config, apply_overrides, default_config

# What an imported detector runs under (`importers/torch_ckpt.py:
# import_config`), as overrides of the commands that read its checkpoint.
IMPORT_OVERRIDES = ("detection.norm=affine detection.voxel_torch_reshape=true "
                    "detection.anchor_offset=0.0 detection.stride_in_1x1=true")


def _parse(argv: List[str]):
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device (default: the GPU; 'cpu' runs "
                             "on the CPU)")
    p = argparse.ArgumentParser(prog="mot3d_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    td = sub.add_parser("train-detection", parents=[common])
    td.add_argument("--data", required=True, help="MOTFront root dir")
    td.add_argument("--voxels", default=None)
    td.add_argument("--out", default="out/detection")
    td.add_argument("--max-iter", type=int, default=None)
    td.add_argument("--cache-samples", type=int, default=256,
                    help="frames kept decoded in memory across epochs "
                         "(~7 MB/frame at full size; 0 disables)")
    td.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --out "
                         "(full state: params, optimizer, step)")

    tc = sub.add_parser("train-combined", parents=[common])
    tc.add_argument("--data", required=True)
    tc.add_argument("--voxels", default=None)
    tc.add_argument("--out", default="out/combined")
    tc.add_argument("--max-iter", type=int, default=None)
    tc.add_argument("--eval-only", action="store_true")
    tc.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --out")
    tc.add_argument("--det-ckpt", default=None,
                    help="detection checkpoint dir to warm-start the "
                         "detector from (the reference protocol, "
                         "Detection/cfg_setup.py:137)")

    ex = sub.add_parser("export-detections", parents=[common])
    ex.add_argument("--data", required=True)
    ex.add_argument("--voxels", default=None)
    ex.add_argument("--split", default="test")
    ex.add_argument("--out", required=True, help="h5 output dir")
    ex.add_argument("--ckpt", default=None, help="detection ckpt dir")
    ex.add_argument("--max-scenes", type=int, default=None)
    ex.add_argument("--oracle", action="store_true",
                    help="use GT as detections (pose/track quality bound)")

    tt = sub.add_parser("train-tracking", parents=[common])
    tt.add_argument("--data", required=True, help="dir of scene h5 folders")
    tt.add_argument("--val-data", required=True)
    tt.add_argument("--out", default="out/tracking")
    tt.add_argument("--epochs", type=int, default=None)
    tt.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --out")

    it = sub.add_parser("infer-tracking", parents=[common])
    it.add_argument("--data", required=True)
    it.add_argument("--ckpt", required=True)
    it.add_argument("--out", default="out/tracking_eval")
    it.add_argument("--export-vis", action="store_true",
                    help="write per-sequence replay.html + trajectory PLYs")

    # The siamese (non-graph) tracker: the reference's `Tracking/train.py`
    # with --use_graph=False, ablations from `Tracking/options.py:36-83`.
    ts = sub.add_parser("train-siamese", parents=[common])
    ts.add_argument("--data", required=True, help="dir of scene h5 folders")
    ts.add_argument("--val-data", required=True)
    ts.add_argument("--out", default="out/siamese")
    ts.add_argument("--epochs", type=int, default=None)
    ts.add_argument("--no-pose", action="store_true")
    ts.add_argument("--no-geo", action="store_true")
    ts.add_argument("--use-triplet", action="store_true")
    ts.add_argument("--use-l1", action="store_true")
    ts.add_argument("--precompute", action="store_true",
                    help="cache voxel-encoder features before training")
    ts.add_argument("--cache-dir", default=None)
    ts.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --out")

    si = sub.add_parser("infer-siamese", parents=[common])
    si.add_argument("--data", required=True)
    si.add_argument("--ckpt", required=True)
    si.add_argument("--out", default="out/siamese_eval")
    si.add_argument("--export-vis", action="store_true",
                    help="write per-sequence replay.html + trajectory PLYs")

    # The reference's protocol starts from torch weights
    # (`Detection/cfg_setup.py:21,137`; `Tracking/mpn_trainer.py:933-960`).
    im = sub.add_parser("import-torch-ckpt", parents=[common])
    im.add_argument("--pth", default=None,
                    help="detectron2-format detector state_dict "
                         "(best_model.pth or COCO zoo)")
    im.add_argument("--voxel-encoder", default=None,
                    help="tracking voxel_encoder.pth")
    im.add_argument("--graph-net", default=None, help="graph_net.pth")
    im.add_argument("--edge-classifier", default=None,
                    help="edge_classifier.pth")
    im.add_argument("--allow-partial", action="store_true",
                    help="keep a fresh init for sections absent from --pth "
                         "(e.g. COCO zoo without voxel/NOCS heads)")
    im.add_argument("--out", required=True,
                    help="checkpoint dir (read by export-detections --ckpt "
                         "/ train-combined --det-ckpt / infer-tracking "
                         "--ckpt; an imported detector runs under "
                         + IMPORT_OVERRIDES + ")")

    # Office (real-world TUM RGB-D) inference: the reference's first-class
    # entry point `Detection/inference_office_dset.py:51-404`.
    io_ = sub.add_parser("infer-office", parents=[common])
    io_.add_argument("--data", required=True, help="office base dir")
    io_.add_argument("--ckpt", default=None, help="detection ckpt dir")
    io_.add_argument("--scene", default=None, help="default: all scenes")
    io_.add_argument("--max-frames", type=int, default=None)
    io_.add_argument("--tracker", choices=("heuristic", "f2f"),
                     default="heuristic")
    io_.add_argument("--fuse", action="store_true",
                     help="fuse_pose smoothing of the trajectories")
    io_.add_argument("--fuse-shapes", action="store_true",
                     help="canonical-shape fusion: replay ONE fused mesh "
                          "per object (fuse_obj_shape)")
    io_.add_argument("--mask-person", action="store_true",
                     help="densepose person masking")
    io_.add_argument("--out", default="out/office")

    args, overrides = p.parse_known_args(argv)
    return args, [o for o in overrides if "=" in o]


def _read_h5_scenes(path: str):
    """Per-scene lists of frame records from an exported .h5 directory."""
    from mot3d_tpu_torch.data.h5_io import read_frame_h5
    per_scene = []
    for scene in sorted(os.listdir(path)):
        sdir = os.path.join(path, scene)
        if not os.path.isdir(sdir):
            continue
        files = sorted((f for f in os.listdir(sdir) if f.endswith(".h5")),
                       key=lambda f: int(f.split(".")[0]))
        per_scene.append([read_frame_h5(os.path.join(sdir, f))
                          for f in files])
    if not per_scene:
        raise FileNotFoundError(f"no scene directories with .h5 frames "
                                f"under {path}")
    return per_scene


def _pad_h5_sequences(datasets, cfg: Config):
    """Pad raw scenes (a list of datasets, each a list of per-scene frame
    lists) to one common frame count and adapt `tracking.seq_len` to it:
    the graph template is static in seq_len, so shorter scenes are
    frame-padded with det_valid=False and a longer dataset grows the
    template."""
    from mot3d_tpu_torch.data.h5_io import pad_sequence
    seq_len = max(len(frames) for ds in datasets for frames in ds)
    if seq_len != cfg.tracking.seq_len:
        print(f"note: dataset sequences have up to {seq_len} frames; using "
              f"tracking.seq_len={seq_len} "
              f"(config had {cfg.tracking.seq_len})")
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, seq_len=seq_len))
    i = cfg.tracking.max_instances_per_frame
    padded = [[pad_sequence(frames, i, i, seq_len=seq_len)
               for frames in ds] for ds in datasets]
    return padded, cfg


def _load_h5_sequences(path: str, cfg: Config):
    """Load one exported .h5 directory; returns (sequences, adapted cfg)."""
    (seqs,), cfg = _pad_h5_sequences([_read_h5_scenes(path)], cfg)
    return seqs, cfg


def _ckpt_dir(path: str) -> str:
    """A trainer's output dir or its ckpt/ subdir."""
    sub = os.path.join(path, "ckpt")
    return sub if os.path.isdir(sub) else path


def _restore_or_die(trainer, ckpt_path: str, metric: str):
    """Restore a trainer state from `ckpt_path` (best-by-metric when
    recorded, else the latest) and refuse to go on with random weights."""
    from mot3d_tpu_torch.train.checkpoints import CheckpointManager
    directory = _ckpt_dir(ckpt_path)
    if not os.path.isdir(directory):
        raise SystemExit(f"no checkpoint directory {directory}; refusing "
                         f"to evaluate random weights")
    mgr = CheckpointManager(directory)
    restored = (mgr.restore_best(metric, trainer.state)
                if metric in mgr.best else mgr.restore(trainer.state))
    if restored is None:
        raise SystemExit(
            f"no checkpoint found under {ckpt_path} (looked in "
            f"{directory}); refusing to evaluate random weights")
    trainer.ckpt = mgr
    trainer.state = restored
    which = f"best-{metric}" if metric in mgr.best else "latest"
    print(f"restored {which} checkpoint at step {restored.step}")


def _init_detector(cfg: Config, ckpt, device):
    """A MaskRCNN (initial weights from run.seed), restored from one of the
    port's detection checkpoint dirs when given (best-by-val_loss
    preferred, like the reference's best_model.pth load,
    `Detection/inference_detector.py:494-535`)."""
    import torch

    from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
    from mot3d_tpu_torch.train.checkpoints import CheckpointManager
    from mot3d_tpu_torch.train.combined_trainer import detection_optimizer
    from mot3d_tpu_torch.train.detection_trainer import DetectionTrainState
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.run.seed)
        model = MaskRCNN(cfg.detection, device=device)
    if ckpt:
        mgr = CheckpointManager(_ckpt_dir(ckpt))
        template = DetectionTrainState(model,
                                       *detection_optimizer(cfg, model))
        restored = (mgr.restore_best("val_loss", template)
                    if "val_loss" in mgr.best else mgr.restore(template))
        if restored is not None:
            print(f"restored checkpoint at step {restored.step}")
    return model


def _import_torch_ckpt(args, cfg: Config, device) -> None:
    """import-torch-ckpt: the reference's .pth files -> the port's
    checkpoints at step 0 (`det/ckpt` and `trk/ckpt` when both parts are
    imported, else `ckpt`), with a fresh AdamW state."""
    import torch

    from mot3d_tpu_torch.importers.torch_ckpt import (
        import_config, import_detectron2_maskrcnn, import_tracking_modules,
        load_torch_state_dict)
    from mot3d_tpu_torch.train.checkpoints import CheckpointManager
    tracking = (args.voxel_encoder, args.graph_net, args.edge_classifier)
    if not (args.pth or any(tracking)):
        raise SystemExit("nothing to import: pass --pth and/or the three "
                         "tracking module paths")
    if any(tracking) and not all(tracking):
        raise SystemExit("tracking import needs all three of "
                         "--voxel-encoder --graph-net --edge-classifier")
    both = bool(args.pth) and any(tracking)

    def save(part, state):
        directory = os.path.join(args.out, part, "ckpt") if both \
            else os.path.join(args.out, "ckpt")
        if not CheckpointManager(directory).save(0, state):
            raise SystemExit(f"a checkpoint at step 0 exists already in "
                             f"{directory}")
        return directory

    if args.pth:
        from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
        from mot3d_tpu_torch.train.combined_trainer import \
            detection_optimizer
        from mot3d_tpu_torch.train.detection_trainer import \
            DetectionTrainState
        det_cfg = import_config(cfg.detection)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.run.seed)
            model = MaskRCNN(det_cfg, device=device)
        sd = import_detectron2_maskrcnn(
            load_torch_state_dict(args.pth), det_cfg,
            init_state_dict=model.state_dict(),
            strict=not args.allow_partial)
        model.load_state_dict(sd)
        state = DetectionTrainState(
            model, *detection_optimizer(cfg.replace(detection=det_cfg),
                                        model))
        n = sum(p.numel() for p in model.parameters())
        print(f"imported detector ({n / 1e6:.1f}M params) -> "
              f"{save('det', state)}; use with {IMPORT_OVERRIDES}")
    if all(tracking):
        from mot3d_tpu_torch.models.mpn import TrackerModel
        from mot3d_tpu_torch.parallel.train_step import TrackingTrainState
        from mot3d_tpu_torch.train.combined_trainer import adamw
        from mot3d_tpu_torch.train.schedules import warmup_multistep
        model = TrackerModel(cfg.graph, device=device)
        model.load_state_dict(import_tracking_modules(
            *(load_torch_state_dict(p) for p in tracking), cfg.graph))
        t = cfg.tracking
        state = TrackingTrainState(model, *adamw(
            model.parameters(), warmup_multistep(t.learning_rate),
            t.weight_decay))
        n = sum(p.numel() for p in model.parameters())
        print(f"imported tracking modules ({n / 1e6:.2f}M params) -> "
              f"{save('trk', state)}")


def _infer_office(args, cfg: Config, device) -> None:
    """infer-office: per scene, `office_inference`, optional smoothing,
    the visual export and `trajectories.json`."""
    import json

    import numpy as np

    from mot3d_tpu_torch.data.office import OfficeDataset, office_inference
    from mot3d_tpu_torch.tracking.smoothing import fuse_pose, fuse_pose_f2f
    from mot3d_tpu_torch.tracking.visualise import export_sequence
    ds = OfficeDataset(args.data,
                       resize_hw=(cfg.camera.height, cfg.camera.width),
                       mask_person=args.mask_person)
    model = _init_detector(cfg, args.ckpt, device)
    for scene in ([args.scene] if args.scene else ds.scenes):
        trajs, per_frame = office_inference(
            cfg, model, ds, scene, max_frames=args.max_frames,
            tracker=args.tracker, device=device)
        if args.fuse:
            # Heuristic-mode detections carry cad2world: the matrix fusion
            # of the F2F variant; segment-centre (f2f) tracks only have
            # locations: translation/rotation fuse_pose.
            trajs = [fuse_pose_f2f(t) if "cad2world" in (t[0] if t else {})
                     else fuse_pose(t) for t in trajs]
        sdir = os.path.join(args.out, scene)
        export_sequence(sdir, trajs, with_shapes=args.tracker != "f2f",
                        fuse_shapes=(args.fuse_shapes
                                     and args.tracker != "f2f"))
        summary = [[{"scan_idx": int(d["scan_idx"]),
                     "loc": np.asarray(d["loc"]).tolist(),
                     "cls": int(d.get("cls", -1))} for d in t]
                   for t in trajs]
        with open(os.path.join(sdir, "trajectories.json"), "w") as f:
            json.dump(summary, f, indent=1)
        n_dets = sum(len(fd) for fd in per_frame)
        print(f"{scene}: {len(trajs)} trajectories from {n_dets} "
              f"detections over {len(per_frame)} frames -> {sdir}")


def main(argv=None):
    args, overrides = _parse(argv if argv is not None else sys.argv[1:])
    # The multi-process rendezvous through the MOT3D_* env vars (the
    # reference's launch(num_machines, machine_rank, dist_url),
    # `Detection/train_net.py:194-201`); a no-op for one process.
    from mot3d_tpu_torch.parallel import multihost
    multihost.maybe_initialize_distributed(device=args.device)
    from mot3d_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    cfg = apply_overrides(default_config(), overrides)

    if args.cmd == "train-tracking":
        from mot3d_tpu_torch.train.tracking_trainer import TrackingTrainer
        (train, val), cfg = _pad_h5_sequences(
            [_read_h5_scenes(args.data), _read_h5_scenes(args.val_data)],
            cfg)
        trainer = TrackingTrainer(cfg, output_dir=args.out, device=device)
        print(trainer.train(train, val, num_epochs=args.epochs,
                            resume=args.resume))

    elif args.cmd == "infer-tracking":
        from mot3d_tpu_torch.train.tracking_trainer import TrackingTrainer
        seqs, cfg = _load_h5_sequences(args.data, cfg)
        trainer = TrackingTrainer(cfg, output_dir=args.out, device=device)
        trainer.init_state()
        _restore_or_die(trainer, args.ckpt, "mota")
        trainer.inference(seqs, classwise=True,
                          export_dir=os.path.join(args.out, "vis")
                          if args.export_vis else None)

    elif args.cmd == "train-siamese":
        from mot3d_tpu_torch.train.siamese_trainer import SiameseTrainer
        s = cfg.siamese
        cfg = cfg.replace(siamese=dataclasses.replace(
            s, no_pose=args.no_pose or s.no_pose,
            no_geo=args.no_geo or s.no_geo,
            use_triplet=args.use_triplet or s.use_triplet,
            use_l1=args.use_l1 or s.use_l1))
        (train, val), cfg = _pad_h5_sequences(
            [_read_h5_scenes(args.data), _read_h5_scenes(args.val_data)],
            cfg)
        trainer = SiameseTrainer(cfg, output_dir=args.out, device=device)
        print(trainer.train(train, val, num_epochs=args.epochs,
                            precompute=args.precompute,
                            cache_dir=args.cache_dir, resume=args.resume))

    elif args.cmd == "infer-siamese":
        from mot3d_tpu_torch.train.siamese_trainer import SiameseTrainer
        seqs, cfg = _load_h5_sequences(args.data, cfg)
        trainer = SiameseTrainer(cfg, output_dir=args.out, device=device)
        trainer.init_state()
        _restore_or_die(trainer, args.ckpt, "mota")
        trainer.inference(seqs, classwise=True,
                          export_dir=os.path.join(args.out, "vis")
                          if args.export_vis else None)

    elif args.cmd == "import-torch-ckpt":
        _import_torch_ckpt(args, cfg, device)

    elif args.cmd == "infer-office":
        _infer_office(args, cfg, device)

    elif args.cmd == "train-detection":
        from mot3d_tpu_torch.data.detection_loader import \
            iterate_detection_batches
        from mot3d_tpu_torch.data.motfront import MOTFrontDataset
        from mot3d_tpu_torch.train.detection_trainer import DetectionTrainer
        ds = MOTFrontDataset(args.data, "train", voxel_dir=args.voxels)
        val_ds = MOTFrontDataset(args.data, "val", voxel_dir=args.voxels)
        trainer = DetectionTrainer(cfg, output_dir=args.out, device=device)
        batches = iterate_detection_batches(
            ds, cfg.detection, cfg.combined.batch_size, epochs=10_000,
            seed=cfg.run.seed, cache_samples=args.cache_samples)
        val = list(iterate_detection_batches(
            val_ds, cfg.detection, cfg.combined.batch_size, shuffle=False))
        print(trainer.train(batches, val, max_iter=args.max_iter,
                            resume=args.resume))

    elif args.cmd == "train-combined":
        from mot3d_tpu_torch.data.detection_loader import load_frame
        from mot3d_tpu_torch.data.motfront import MOTFrontDataset
        from mot3d_tpu_torch.train.combined_trainer import (
            CombinedTrainer, samples_to_combined_window)
        ds = MOTFrontDataset(args.data, "train", voxel_dir=args.voxels)
        test_ds = MOTFrontDataset(args.data, "test", voxel_dir=args.voxels)
        trainer = CombinedTrainer(cfg, output_dir=args.out, device=device)

        def windows():
            t = cfg.combined.batch_size
            while True:
                for scene in ds.scenes():
                    frames = ds.load_scene(scene).frames
                    for i in range(0, len(frames) - t + 1, t):
                        yield [load_frame(ds, fr, cfg.detection)
                               for fr in frames[i:i + t]]

        test_seqs = [[load_frame(test_ds, fr, cfg.detection)
                      for fr in test_ds.load_scene(s).frames]
                     for s in test_ds.scenes()[:8]]
        det_init = (_init_detector(cfg, args.det_ckpt, device).state_dict()
                    if args.det_ckpt else None)
        if args.eval_only:
            trainer.init_state(samples_to_combined_window(next(windows())),
                               det_params=det_init)
            print(trainer.do_test(test_seqs))
        else:
            print(trainer.train(windows(), max_iter=args.max_iter,
                                test_seqs=test_seqs, resume=args.resume,
                                det_init_params=det_init))

    elif args.cmd == "export-detections":
        from mot3d_tpu_torch.data.motfront import MOTFrontDataset
        from mot3d_tpu_torch.export import DetectorExporter
        ds = MOTFrontDataset(args.data, args.split, voxel_dir=args.voxels)
        model = _init_detector(cfg, args.ckpt, device)
        exporter = DetectorExporter(cfg, model, device)
        print(exporter.export_split(ds, args.out, max_scenes=args.max_scenes,
                                    oracle=args.oracle))


if __name__ == "__main__":
    main()
