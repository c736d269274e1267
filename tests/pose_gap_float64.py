"""Per-instance oracle poses of the two packages' pose stages in float32
and in float64, on the test split of `chip_smoke.py`'s workflow fixture,
on the CPU.

    JAX_PLATFORMS=cpu python tests/pose_gap_float64.py [--frames N]

Each frame (2 scenes x 25 frames, 3 objects each, seed 3, the default
240 x 320 camera) is read by the port's loader, and its oracle detections
(GT boxes, the GT masks pooled to 28 x 28, GT NOCS patches and voxels) and
cropped GT 3D boxes are made once by the port's exporter, in the precision
under test.  Both pose stages (`postprocess_frame`) then run on those same
arrays with the same RANSAC draws: JAX's key chain of `export_split`, the
per-slot draws rebuilt inside the same x64 context as the JAX call
(`torch_port_helpers.slot_draws`; x64 changes `randint`'s numbers).  In
float64 the JAX call runs under `jax.enable_x64` on float64 arrays and the
port on float64 tensors.  Prints one JSON line per precision: the
instance count (valid fits of either side), the slots where one side fits
and the other does not, and the largest per-instance differences of the
fitted rotations, translations and scales.
Not a test (no `test_` prefix); it takes a few minutes.
"""

import argparse
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from mot3d_tpu.config import Config  # noqa: E402
from mot3d_tpu.pose.pipeline import postprocess_frame as post_j  # noqa
from mot3d_tpu_torch.data.detection_loader import load_frame  # noqa: E402
from mot3d_tpu_torch.data.fixtures import write_motfront_fixture  # noqa
from mot3d_tpu_torch.data.motfront import MOTFrontDataset  # noqa: E402
from mot3d_tpu_torch.export import DetectorExporter  # noqa: E402
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN  # noqa: E402
from mot3d_tpu_torch.pose.pipeline import (crop_gt_box3d,  # noqa: E402
                                           postprocess_frame)
from torch_port_helpers import port_config, slot_draws  # noqa: E402

SCENES, FRAMES, OBJECTS, TEST_SEED = 2, 25, 3, 3
RENDER = dict(half_range=(0.35, 0.6), camera_dist=2.6)
POSE = ("rotations", "translations", "scales")


def _inputs(ex, sample):
    """The pose stage's inputs of one oracle frame, made by the port's
    exporter in its dtype: (the 12 array arguments of `postprocess_frame`
    before the key / draws, with the intrinsics and the cropped GT boxes)."""
    cam = ex.cfg.camera
    t = ex._t
    boxes, valid, masks = t(sample.boxes), t(sample.valid, torch.bool), \
        t(sample.masks)
    depth, campose = t(sample.depth), t(sample.campose)
    dets = ex._oracle_detections(sample, boxes, valid, masks,
                                 t(sample.voxels))
    cropped = crop_gt_box3d(depth, campose, ex.intrinsics, t(sample.boxes3d),
                            boxes, masks[:, :cam.height, :cam.width])
    return [x.numpy() for x in (
        dets.boxes[0], dets.scores[0], dets.classes[0], dets.valid[0],
        dets.masks[0], dets.voxels[0], dets.nocs[0], boxes, valid, depth,
        campose, ex.intrinsics, cropped)]


def run(root, frames, x64):
    cfg = Config()
    cfg_t = port_config(cfg)
    ds = MOTFrontDataset(root, "test")
    det = MaskRCNN(cfg_t.detection, device="cpu")
    ex = DetectorExporter(cfg_t, det.double() if x64 else det, "cpu")
    p = cfg.pose
    out = {"precision": "float64" if x64 else "float32", "frames": 0,
           "instances": 0, "fit_mismatches": 0}
    out.update({k: 0.0 for k in POSE})
    rng = jax.random.PRNGKey(0)
    with jax.enable_x64(x64):
        pose_j = jax.jit(lambda *a: post_j(*a, cfg))
        for scene in ds.scenes():
            for fr in ds.load_scene(scene).frames:
                if out["frames"] >= frames:
                    break
                rng, key = jax.random.split(rng)
                args = _inputs(ex, load_frame(ds, fr, cfg_t.detection))
                got_j = jax.device_get(pose_j(*map(jnp.asarray, args), key))
                draws = slot_draws(key, cfg.detection.max_instances,
                                   p.ransac_iters, p.ransac_sample_size)
                got_t = postprocess_frame(
                    *map(torch.from_numpy, args[:-1]), torch.from_numpy(
                        args[-1]), cfg_t, draws=torch.from_numpy(draws))
                v_j = np.asarray(got_j.valid)
                v_t = got_t.valid.numpy()
                both = v_j & v_t
                out["fit_mismatches"] += int((v_j != v_t).sum())
                out["instances"] += int((v_j | v_t).sum())
                for k in POSE:
                    a = getattr(got_t, k).numpy()[both]
                    b = np.asarray(getattr(got_j, k))[both]
                    if len(a):
                        out[k] = max(out[k], float(np.abs(a - b).max()))
                out["frames"] += 1
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=SCENES * FRAMES)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as root:
        write_motfront_fixture(root, "test", SCENES, FRAMES, OBJECTS,
                               TEST_SEED, **RENDER)
        for x64 in (False, True):
            print(json.dumps(run(root, args.frames, x64)), flush=True)


if __name__ == "__main__":
    main()
