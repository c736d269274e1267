"""Minimal .binvox codec (dense 3D occupancy grids); a copy of
`mot3d_tpu/data/binvox.py` (pure numpy).

Replaces `BlenderProc/utils/binvox_rw.py` for the train-time voxel loading
path (`Detection/utils/train_utils.py:226-245`).  Format: ASCII header
(#binvox 1 / dim / translate / scale / data) followed by (value, count)
run-length byte pairs over the grid flattened in x-major (x, z, y) order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BinvoxGrid(NamedTuple):
    data: np.ndarray          # (d, d, d) bool, axes (x, y, z)
    translate: tuple
    scale: float


def read_binvox(path: str) -> BinvoxGrid:
    with open(path, "rb") as f:
        line = f.readline().strip()
        if not line.startswith(b"#binvox"):
            raise ValueError(f"{path}: not a binvox file")
        dims, translate, scale = None, (0.0, 0.0, 0.0), 1.0
        while True:
            line = f.readline().strip()
            if line.startswith(b"data"):
                break
            tok = line.split()
            if tok[0] == b"dim":
                dims = tuple(int(x) for x in tok[1:])
            elif tok[0] == b"translate":
                translate = tuple(float(x) for x in tok[1:])
            elif tok[0] == b"scale":
                scale = float(tok[1])
        if dims is None:
            raise ValueError(f"{path}: missing dim header")
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    values, counts = raw[::2], raw[1::2].astype(np.int64)
    flat = np.repeat(values, counts).astype(bool)
    size = int(np.prod(dims))
    if flat.size != size:
        raise ValueError(f"{path}: RLE decodes to {flat.size}, expected {size}")
    # On-disk order is x-major (x, z, y); transpose to (x, y, z).
    return BinvoxGrid(flat.reshape(dims).transpose(0, 2, 1), translate, scale)


def write_binvox(path: str, data: np.ndarray,
                 translate=(0.0, 0.0, 0.0), scale: float = 1.0) -> None:
    data = np.asarray(data).astype(bool)
    d = data.shape[0]
    flat = data.transpose(0, 2, 1).reshape(-1)  # back to (x, z, y) order
    # Run-length encode with max run 255.
    change = np.nonzero(np.diff(flat))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [flat.size]])
    pairs = []
    for s, e in zip(starts, ends):
        v, run = int(flat[s]), e - s
        while run > 0:
            c = min(run, 255)
            pairs.append((v, c))
            run -= c
    with open(path, "wb") as f:
        f.write(b"#binvox 1\n")
        f.write(f"dim {d} {d} {d}\n".encode())
        f.write(("translate %g %g %g\n" % tuple(translate)).encode())
        f.write(f"scale {scale}\n".encode())
        f.write(b"data\n")
        f.write(bytes(np.array(pairs, np.uint8).reshape(-1)))


def rescale_voxel(grid: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Anisotropic rescale of an occupancy grid about its centre.

    Matches the reference semantics (`Detection/utils/train_utils.py:247-275`):
    occupied coordinates are scaled by scale/scale.max() around the grid
    centre, rounded, clamped, and re-rasterised.
    """
    scale = np.asarray(scale, np.float64)
    if np.all(scale == scale.max()):
        return grid.astype(np.float32)
    d = grid.shape[0]
    centre = d / 2
    xyz = np.stack(np.nonzero(grid), axis=1).astype(np.float64)
    xyz = (xyz - centre) * (scale / scale.max())
    xyz = np.clip(np.rint(xyz) + centre, 0, d - 1).astype(np.int64)
    out = np.zeros_like(grid, dtype=np.float32)
    out[xyz[:, 0], xyz[:, 1], xyz[:, 2]] = 1.0
    return out
