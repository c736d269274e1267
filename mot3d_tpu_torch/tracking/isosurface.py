"""Isosurface mesh extraction for voxel grids (vox2mesh parity;
counterpart of `mot3d_tpu/tracking/isosurface.py`).

The reference converts predicted 32^3 occupancy grids to triangle meshes
with PyMCubes marching cubes for its dvis replay
(`Tracking/visualise/visualise.py:592-617` vox2mesh: `mcubes.marching_cubes
(volume, 0.5)` + vertex scaling to the unit CAD box).  mcubes is not
available here, so this is a from-scratch **marching tetrahedra** extractor:
each cell is split into 6 tetrahedra and each tetrahedron contributes 0-2
triangles with vertices linearly interpolated onto the isolevel — the same
smooth isosurface family as marching cubes, with no 256-case tables, fully
vectorised in NumPy (no per-voxel Python loop).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Cube corner offsets, indexed 0..7.
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64)

# Six tetrahedra covering the cube (all sharing the 0-6 diagonal).
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int64)

# For a tet with inside-mask bits (v0..v3) -> the 3 or 6 edge picks
# (pairs of local tet-vertex indices), padded with -1.  One triangle:
# rows 0-2; two triangles: rows 0-5.  Built once below.


def _tet_cases():
    cases = {}
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for mask in range(16):
        inside = [bool(mask >> i & 1) for i in range(4)]
        cut = [e for e in edges if inside[e[0]] != inside[e[1]]]
        n_in = sum(inside)
        if n_in in (0, 4):
            cases[mask] = np.full((6, 2), -1, np.int64)
            continue
        if n_in in (1, 3):
            # one vertex isolated -> 3 cut edges -> 1 triangle
            apex = inside.index(True) if n_in == 1 else inside.index(False)
            tri = [e for e in cut if apex in e]
            assert len(tri) == 3
            arr = np.full((6, 2), -1, np.int64)
            arr[:3] = tri
            cases[mask] = arr
        else:
            # 2-2 split -> 4 cut edges -> quad -> 2 triangles.
            assert len(cut) == 4
            # Order the quad: consecutive edges share a tet face.
            e0 = cut[0]
            rest = cut[1:]
            order = [e0]
            while rest:
                last = order[-1]
                for e in rest:
                    # adjacent iff they share a face = share one endpoint's
                    # side (one common vertex among the 4 involved)
                    if len({last[0], last[1]} & {e[0], e[1]}) == 1:
                        order.append(e)
                        rest.remove(e)
                        break
                else:
                    order.append(rest.pop(0))
            o = np.asarray(order, np.int64)
            cases[mask] = np.stack([o[0], o[1], o[2], o[0], o[2], o[3]])
    return np.stack([cases[m] for m in range(16)])  # (16, 6, 2)


_TET_TABLE = _tet_cases()


def marching_tetrahedra(volume: np.ndarray, level: float = 0.5
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """volume (R, R, R) float -> (verts (V, 3), faces (F, 3)).

    Vertices are in voxel-index coordinates (like mcubes), linearly
    interpolated onto `level` along cut edges.
    """
    vol = np.asarray(volume, np.float64)
    r = vol.shape[0]
    if vol.max() <= level or vol.min() > level:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    # All cell origins (r-1)^3, corner values (C, 8).
    idx = np.stack(np.meshgrid(*[np.arange(r - 1)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    corner_pos = idx[:, None, :] + _CORNERS[None]          # (C, 8, 3)
    vals = vol[corner_pos[..., 0], corner_pos[..., 1],
               corner_pos[..., 2]]                          # (C, 8)

    # Skip cells with no crossing at all.
    inside = vals > level
    active = inside.any(1) & ~inside.all(1)
    corner_pos, vals, inside = (corner_pos[active], vals[active],
                                inside[active])
    if len(vals) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    tris = []
    for tet in _TETS:                                       # 6 iterations
        tv = vals[:, tet]                                   # (C, 4)
        tp = corner_pos[:, tet]                             # (C, 4, 3)
        mask = ((tv > level) << np.arange(4)).sum(1)        # (C,)
        picks = _TET_TABLE[mask]                            # (C, 6, 2)
        has2 = picks[:, 3, 0] >= 0
        has1 = picks[:, 0, 0] >= 0

        def emit(sel, rows):
            p = picks[sel][:, rows]                         # (N, 3, 2)
            n = np.arange(p.shape[0])[:, None]
            v0 = tv[sel][n, p[..., 0]]                      # (N, 3)
            v1 = tv[sel][n, p[..., 1]]
            p0 = tp[sel][n, p[..., 0]].astype(np.float64)   # (N, 3, 3)
            p1 = tp[sel][n, p[..., 1]].astype(np.float64)
            t = (level - v0) / np.where(np.abs(v1 - v0) < 1e-12, 1e-12,
                                        v1 - v0)
            return p0 + t[..., None] * (p1 - p0)            # (N, 3, 3)

        if has1.any():
            tris.append(emit(has1, [0, 1, 2]))
        if has2.any():
            tris.append(emit(has2, [3, 4, 5]))

    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tri_pts = np.concatenate(tris, 0)                       # (T, 3, 3)

    # Weld duplicate vertices.
    flat = tri_pts.reshape(-1, 3)
    key = np.round(flat * 1e6).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3))
    verts[inv] = flat
    faces = inv.reshape(-1, 3)
    # Drop degenerate triangles.
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


def vox2mesh(grid: np.ndarray, level: float = 0.5,
             pad: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Occupancy grid -> mesh in the unit CAD box [-0.5, 0.5]^3
    (the reference's vox2mesh scaling, `visualise.py:592-617`:
    verts / (res-1) - 0.5).  `pad` closes surfaces at the grid boundary
    (the reference drops boundary shells); padded vertices may overhang
    the unit box by up to one cell."""
    g = np.asarray(grid, np.float64)
    res = g.shape[0]
    if pad:
        g = np.pad(g, 1)
    verts, faces = marching_tetrahedra(g, level)
    if pad:
        verts = verts - 1.0
    return verts / (res - 1) - 0.5, faces
