"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file (`traffic/<name>.json`) is data: its `kind` says which
inputs it asks for and the rest are their parameters.

- `sequences`: closed-loop sequence serving.  `clients` processes each
  cycle a pool of `pool` synthetic sequences (`sequence`) made from the
  seed and the client's index, `objects` box-shaped objects each and a
  camera that pans by `pan_m` per frame; one sequence per call.
- `detection_batches`: training batches of `batch` frames, `pool` of them,
  each frame a different frame of a synthetic sequence with its masks,
  voxels and NOCS targets (`train_frames`).  With `ranks` > 1 that many
  data-parallel ranks share the pool, `batch` frames each a step
  (`train_dp.batch_index`).

The same seed gives the same inputs; every seed gives the same sizes.
The scene is a copy of the port's smoke run's (`chip_smoke.py:_sequence`
and `_train_frames`), frozen here."""

from __future__ import annotations

import numpy as np

SIGNS = np.array([[1, 1, 1], [1, 1, -1], [-1, 1, -1], [-1, 1, 1],
                  [1, -1, 1], [1, -1, -1], [-1, -1, -1], [-1, -1, 1]],
                 np.float32)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (2 ** 63), *stream])


def sequence(rng, cfg: dict, objects: int, pan_m: float,
             cam_x: float = 0.0) -> dict:
    """One synthetic sequence of `tracking.seq_len` frames: a room (tilted
    floor-to-wall depth) with box-shaped objects, a camera that pans
    slowly, and the objects' GT 2D boxes, world 3D boxes and identities.
    `cfg` is a configuration dict."""
    det, cam = cfg["detection"], cfg["camera"]
    t, m = cfg["tracking"]["seq_len"], det["max_instances"]
    h, w = cam["height"], cam["width"]
    fx, fy = cam["fx"], cam["fy"]
    cx, cy = w / 2 - 0.5, h / 2 - 0.5    # CameraConfig.cx, .cy
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    objs = [(rng.uniform(0.06, 0.7) * w, rng.uniform(0.08, 0.6) * h,
             rng.uniform(0.12, 0.28) * w, rng.uniform(0.16, 0.33) * h,
             rng.uniform(1.5, 3.0)) for _ in range(min(objects, m))]
    images = np.zeros((t, det["pad_height"], det["pad_width"], 3),
                      np.float32)
    depth = np.zeros((t, h, w), np.float32)
    campose = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1))
    boxes2d = np.zeros((t, m, 4), np.float32)
    boxes3d = np.zeros((t, m, 8, 3), np.float32)
    gt_valid = np.zeros((t, m), bool)
    for f in range(t):
        shift = 0.005 * w * f
        d = 4.0 - 1.5 * vv / h + 0.002 * uu
        img = np.round(rng.uniform(40, 90, (h, w, 3)))
        campose[f, 0, 3] = pan_m * f + cam_x
        for j, (x, y, bw, bh, z) in enumerate(objs):
            x0, y0 = int(x - shift), int(y)
            x1, y1 = int(x0 + bw), int(y0 + bh)
            if x1 <= 0:
                continue
            x0 = max(x0, 0)
            d[y0:y1, x0:x1] = z + 0.001 * (uu[y0:y1, x0:x1] - x0)
            img[y0:y1, x0:x1] = 60 + 40 * j
            boxes2d[f, j] = [x0, y0, x1, y1]
            zs = d[y0:y1, x0:x1]
            us, vs = uu[y0:y1, x0:x1], vv[y0:y1, x0:x1]
            pts = np.stack([(us - cx) / fx * zs,
                            -((vs - cy) / fy * zs), -zs], -1)
            world = pts.reshape(-1, 3) + campose[f, :3, 3]
            lo, hi = world.min(0), world.max(0)
            boxes3d[f, j] = (lo + hi) / 2 + SIGNS * (hi - lo) / 2
            gt_valid[f, j] = True
        depth[f] = d
        images[f, :h] = img
    ids = np.tile(np.arange(m, dtype=np.int32), (t, 1))
    return dict(images=images, depth=depth, campose=campose,
                gt_boxes2d=boxes2d, gt_valid2d=gt_valid, gt_boxes3d=boxes3d,
                gt_boxes3d_cropped=boxes3d, gt_ids=ids, gt_valid=gt_valid)


def ransac_draws(rng, cfg: dict) -> np.ndarray:
    """One sequence's raw RANSAC draws (T, I, iters, S) in [0, 2^31 - 1)."""
    p = cfg["pose"]
    return rng.integers(0, 2 ** 31 - 1, (
        cfg["tracking"]["seq_len"], cfg["detection"]["detections_per_image"],
        p["ransac_iters"], p["ransac_sample_size"]), dtype=np.int64)


def client_pool(seed: int, client: int, traffic: dict, cfg: dict) -> list:
    """The sequences (with their draws) that client `client` cycles."""
    out = []
    for q in range(traffic["pool"]):
        rng = rng_for(seed, 1, client, q)
        seq = sequence(rng, cfg, traffic["objects"], traffic["pan_m"],
                       0.1 * q)
        out.append((seq, ransac_draws(rng, cfg)))
    return out


def nocs_ramp(p: int = 28) -> np.ndarray:
    """(P, P, 3) NOCS patch: x and y ramp from 0.1 to 0.9 over the box, z
    is 0.5."""
    ramp = np.linspace(0.1, 0.9, p, dtype=np.float32)
    return np.stack([np.tile(ramp, (p, 1)), np.tile(ramp[:, None], (1, p)),
                     np.full((p, p), 0.5, np.float32)], axis=-1)


def class_voxels(cls: int) -> np.ndarray:
    """(32, 32, 32) solid box whose height depends on the class."""
    g = np.zeros((32, 32, 32), np.float32)
    d = 8 + 2 * (cls % 6)
    g[4:4 + d, 4:28, 6:26] = 1.0
    return g


def train_frames(seq: dict, cfg: dict) -> list:
    """A sequence's frames as training frames (dicts of the detection
    sample's fields): each object gets its mask (its 2D box), a 32^3
    solid-box voxel grid of its class and a 28 x 28 NOCS ramp."""
    det = cfg["detection"]
    t, m = seq["gt_valid2d"].shape
    nocs = nocs_ramp(28)
    classes = (np.arange(m) % det["num_classes"]).astype(np.int32)
    voxels = np.stack([class_voxels(int(c)) for c in classes]) > 0.5
    frames = []
    for f in range(t):
        masks = np.zeros((m, det["pad_height"], det["pad_width"]), bool)
        for j, (x0, y0, x1, y1) in enumerate(seq["gt_boxes2d"][f]):
            if seq["gt_valid2d"][f, j]:
                masks[j, int(y0):int(y1), int(x0):int(x1)] = True
        frames.append(dict(
            image=seq["images"][f].astype(np.uint8), boxes=seq["gt_boxes2d"][f],
            classes=classes, valid=seq["gt_valid2d"][f], masks=masks,
            voxels=voxels, nocs=np.repeat(nocs[None], m, 0)))
    return frames


def detection_batches(seed: int, traffic: dict, cfg: dict) -> list:
    """`pool` batches of `batch` frames, all frames different: frame i of
    the pool is frame i % T of sequence i // T."""
    t = cfg["tracking"]["seq_len"]
    need = traffic["pool"] * traffic["batch"]
    frames = []
    for q in range((need + t - 1) // t):
        rng = rng_for(seed, 2, q)
        frames += train_frames(sequence(rng, cfg, traffic["objects"],
                                        traffic["pan_m"], 0.1 * q), cfg)
    b = traffic["batch"]
    return [{k: np.stack([fr[k] for fr in frames[i * b:(i + 1) * b]])
             for k in frames[0]} for i in range(traffic["pool"])]
