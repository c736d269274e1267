"""The JAX package's oracle export on the test split of `chip_smoke.py`'s
workflow fixture, on the CPU: the reference values that the smoke's
`JAX_ORACLE_TEST` constants hold.

    JAX_PLATFORMS=cpu python tests/jax_oracle_reference.py [--out DIR]

It writes the split with the JAX package's `write_motfront_fixture` (2
scenes x 25 frames, 3 objects each, seed 3, the default 240 x 320 camera,
`half_range=(0.35, 0.6)`, `camera_dist=2.6`), exports every frame with
`DetectorExporter.export_frame(oracle=True)` under the JAX key chain of
`export_split`, and prints one JSON line: the instance count, the minimum
voxel IoU and the median rotation (degrees) and location (metres) errors.
Not a test (no `test_` prefix); it takes about a minute.
"""

import argparse
import json
import os
import sys
import tempfile

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mot3d_tpu.config import Config  # noqa: E402
from mot3d_tpu.data.detection_loader import load_frame  # noqa: E402
from mot3d_tpu.data.fixtures import write_motfront_fixture  # noqa: E402
from mot3d_tpu.data.motfront import MOTFrontDataset  # noqa: E402
from mot3d_tpu.export import DetectorExporter  # noqa: E402
from mot3d_tpu.models.mask_rcnn import MaskRCNN  # noqa: E402

# The smoke's workflow fixture (chip_smoke.py: WORKFLOW_FIXTURE).
SCENES, FRAMES, OBJECTS, TEST_SEED = 2, 25, 3, 3
RENDER = dict(half_range=(0.35, 0.6), camera_dist=2.6)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="fixture dir (default: a "
                    "temporary one)")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        write_motfront_fixture(root, "test", SCENES, FRAMES, OBJECTS,
                               TEST_SEED, **RENDER)
        cfg = Config()
        ds = MOTFrontDataset(root, "test")
        ex = DetectorExporter(cfg, MaskRCNN(cfg.detection), None)
        rng = jax.random.PRNGKey(0)
        rot, loc, viou = [], [], []
        for scene in ds.scenes():
            for fr in ds.load_scene(scene).frames:
                rng, sub = jax.random.split(rng)
                m = ex.export_frame(load_frame(ds, fr, cfg.detection), None,
                                    sub, oracle=True)
                rot += m["rot_err"]
                loc += m["loc_err"]
                viou += m["voxel_iou"]
    print(json.dumps({"frames": SCENES * FRAMES, "instances": len(rot),
                      "voxel_iou_min": float(np.min(viou)),
                      "rot_err_median_deg": float(np.median(rot)),
                      "loc_err_median_m": float(np.median(loc))}))


if __name__ == "__main__":
    main()
