"""Mesh voxelization and point-in-mesh (counterpart of
`mot3d_tpu/data/voxelize.py`): the C++ of `native/voxelize/voxelize.cpp`
through ctypes, built at first use by `utils/native.py`, with the numpy
versions beside it as the plain reference (`*_plain`).  Unlike the JAX
package, which switches to numpy when its library is missing, a failed
build raises.

Replaces the reference's vendored `BlenderProc/utils/libvoxelize` (tri-box
SAT voxelizer), `libmesh/triangle_hash` (2D triangle buckets) and
`voxels.py` VoxelGrid helpers: the offline preprocessing that regenerates
CAD voxel caches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from mot3d_tpu_torch.utils import native

_I64 = ctypes.c_int64
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The voxelizer, with every entry point's signature declared."""
    lib = native.library("voxelize")
    for name, res, args in (
            ("tri_box_overlap", ctypes.c_int, [_F64P, _F64P, _F64P]),
            ("voxelize_mesh", None, [_F64P, _I64, _I64, _U8P]),
            ("points_in_mesh", None, [_F64P, _I64, _I32P, _I64, _F64P, _I64,
                                      _I64, _U8P])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _triangles(vertices, faces) -> np.ndarray:
    return _f64(np.asarray(vertices)[np.asarray(faces, np.int64)])


def _centres(resolution: int) -> np.ndarray:
    """The voxel centres of a unit-cube grid, C-order (res^3, 3)."""
    return (np.stack(np.meshgrid(*[np.arange(resolution)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)
            + 0.5) / resolution


# ------------------------------------------------------------- native


def tri_box_overlap(box_center, box_half, triangle) -> bool:
    """Akenine-Moller separating-axis triangle/AABB test."""
    c, h = _f64(box_center), _f64(box_half)
    t = _f64(triangle).reshape(9)
    return bool(_lib().tri_box_overlap(_ptr(c, _F64P), _ptr(h, _F64P),
                                       _ptr(t, _F64P)))


def voxelize_surface(vertices: np.ndarray, faces: np.ndarray,
                     resolution: int = 32) -> np.ndarray:
    """Surface-voxelize a mesh given in unit-cube coords [0, 1]^3.

    vertices (V, 3); faces (F, 3) int.  Returns (res, res, res) bool grid.
    """
    tris = _triangles(vertices, faces)
    grid = np.zeros(resolution ** 3, np.uint8)
    _lib().voxelize_mesh(_ptr(tris, _F64P), len(tris), resolution,
                         _ptr(grid, _U8P))
    return grid.reshape((resolution,) * 3).astype(bool)


def points_in_mesh(vertices: np.ndarray, faces: np.ndarray,
                   points: np.ndarray, grid_res: int = 64) -> np.ndarray:
    """Ray-parity point-in-mesh test (+Z stabbing with 2D triangle buckets).

    Mirrors `BlenderProc/utils/libmesh/inside_mesh.py:5-154`.
    """
    v, p = _f64(vertices), _f64(points)
    f = np.ascontiguousarray(faces, np.int32)
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("points_in_mesh: a face indexes no vertex")
    out = np.zeros(len(p), np.uint8)
    _lib().points_in_mesh(_ptr(v, _F64P), len(v), _ptr(f, _I32P), len(f),
                          _ptr(p, _F64P), len(p), grid_res, _ptr(out, _U8P))
    return out.astype(bool)


def voxelize_fill(vertices: np.ndarray, faces: np.ndarray,
                  resolution: int = 32) -> np.ndarray:
    """Solid voxelization: surface + interior fill via point-in-mesh
    (`BlenderProc/utils/voxels.py` voxelize_fill/interior semantics)."""
    surf = voxelize_surface(vertices, faces, resolution)
    inside = points_in_mesh(vertices, faces, _centres(resolution))
    return np.logical_or(surf, inside.reshape(surf.shape))


# -------------------------------------------------------------- plain


def tri_box_overlap_plain(box_center, box_half, triangle) -> bool:
    c, h = _f64(box_center), _f64(box_half)
    v = _f64(triangle).reshape(3, 3) - c
    for a in range(3):                       # the box's axes
        if v[:, a].min() > h[a] or v[:, a].max() < -h[a]:
            return False
    e = np.array([v[1] - v[0], v[2] - v[1], v[0] - v[2]])
    n = np.cross(e[0], e[1])                 # the triangle's plane
    if abs(np.dot(n, v[0])) > np.abs(n) @ h:
        return False
    units = np.eye(3)
    for i in range(3):                       # the 9 cross axes
        for j in range(3):
            axis = np.cross(units[j], e[i])
            p = v @ axis
            rad = np.abs(axis) @ h
            if p.min() > rad or p.max() < -rad:
                return False
    return True


def voxelize_surface_plain(vertices: np.ndarray, faces: np.ndarray,
                           resolution: int = 32) -> np.ndarray:
    tris = _triangles(vertices, faces)
    cell = 1.0 / resolution
    g = np.zeros((resolution,) * 3, bool)
    half = np.full(3, cell / 2)
    for tri in tris:
        lo = np.clip(np.floor(tri.min(0) * resolution).astype(int), 0,
                     resolution - 1)
        hi = np.clip(np.floor(tri.max(0) * resolution).astype(int), 0,
                     resolution - 1)
        for i in range(lo[0], hi[0] + 1):
            for j in range(lo[1], hi[1] + 1):
                for k in range(lo[2], hi[2] + 1):
                    if not g[i, j, k] and tri_box_overlap_plain(
                            (np.array([i, j, k]) + 0.5) * cell, half, tri):
                        g[i, j, k] = True
    return g


def points_in_mesh_plain(vertices: np.ndarray, faces: np.ndarray,
                         points: np.ndarray) -> np.ndarray:
    """Brute force over the triangles.  The queries are nudged by a tiny
    incommensurate offset so that no ray passes exactly through an edge
    two triangles share (counted twice, it would flip the parity)."""
    v = _f64(vertices)
    tris = v[np.asarray(faces, np.int64)]
    ext = v.max(0) - v.min(0) + 1e-12
    p = _f64(points) + np.array([1.3719e-7 * ext[0], 0.7129e-7 * ext[1],
                                 0.0])
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    d = ((b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0])
         + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1]))
    inside = np.zeros(len(p), bool)
    for i, pt in enumerate(p):
        # A degenerate (vertical) triangle divides by d = 0; its NaN and
        # infinite weights fail the `hit` test.
        with np.errstate(divide="ignore", invalid="ignore"):
            l1 = ((b[:, 1] - c[:, 1]) * (pt[0] - c[:, 0])
                  + (c[:, 0] - b[:, 0]) * (pt[1] - c[:, 1])) / d
            l2 = ((c[:, 1] - a[:, 1]) * (pt[0] - c[:, 0])
                  + (a[:, 0] - c[:, 0]) * (pt[1] - c[:, 1])) / d
            l3 = 1 - l1 - l2
            hit = (l1 >= 0) & (l2 >= 0) & (l3 >= 0) & (np.abs(d) > 1e-15)
            z = l1 * a[:, 2] + l2 * b[:, 2] + l3 * c[:, 2]
        inside[i] = ((z[hit] > pt[2]).sum() % 2) == 1
    return inside


def voxelize_fill_plain(vertices: np.ndarray, faces: np.ndarray,
                        resolution: int = 32) -> np.ndarray:
    surf = voxelize_surface_plain(vertices, faces, resolution)
    inside = points_in_mesh_plain(vertices, faces, _centres(resolution))
    return np.logical_or(surf, inside.reshape(surf.shape))
