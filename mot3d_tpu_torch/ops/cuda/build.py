"""Build and load the port's CUDA kernels.

The sources under `mot3d_tpu_torch/csrc/` are compiled by `nvcc` for
`sm_90a` into one shared library with a plain C interface,
`build/kernels/libmot3d_kernels.so` at the root of the checkout, and loaded
with `ctypes`.  One `nvcc -c` per source runs in parallel, then one link.
The build is keyed on a hash of the sources and flags, so an unchanged
checkout builds once; a file lock keeps concurrent processes from building
at the same time (`utils/native.py:locked_build`).  Nothing here runs at
import: the first CUDA launch builds, or a caller (such as
`chip_smoke.py`) calls `build()` directly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
import time
from pathlib import Path

from mot3d_tpu_torch.utils.native import locked_build, run_all, source_key

SOURCES = ("knn_outlier.cu", "pose_extract.cu", "nms.cu", "roi_align.cu")
CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libmot3d_kernels.so"

# -fmad=false: every kernel must round like its plain PyTorch version, whose
# multiplies and adds are separate operations.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float
    cached: bool
    ptxas: tuple  # the -Xptxas -v lines: registers, shared memory, spills


class LaunchCounter:
    """Counts the launches of one kernel; its wrapper adds one per launch."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built from "
                           f"{CSRC} on first use")
    return found


def build() -> BuildResult:
    """Compile the kernels unless a library built from the same sources and
    flags is already there."""
    lib = BUILD_DIR / LIB_NAME
    t0 = time.perf_counter()

    def make(tmp: Path) -> str:
        nvcc = _nvcc()
        objs = [BUILD_DIR / (Path(s).stem + ".o") for s in SOURCES]
        log = run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                       for s, o in zip(SOURCES, objs)])
        return log + run_all([[nvcc, "-shared", "-gencode",
                               "arch=compute_90a,code=sm_90a",
                               *map(str, objs), "-o", str(tmp)]])

    log = locked_build(lib, source_key(NVCC_FLAGS,
                                       [CSRC / s for s in SOURCES]), make)
    if log is None:
        return BuildResult(lib, time.perf_counter() - t0, True, ())
    ptxas = tuple(line.strip() for line in log.splitlines()
                  if "ptxas" in line or "spill" in line)
    return BuildResult(lib, time.perf_counter() - t0, False, ptxas)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build().path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mot3d_knn_mean_dists.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mot3d_knn_mean_dists.restype = i
    lib.mot3d_pose_extract.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                       i, f, p]
    lib.mot3d_pose_extract.restype = i
    lib.mot3d_nms_mask.argtypes = [p, p, p, p,
                                   ctypes.POINTER(ctypes.c_longlong), i, f,
                                   p, ctypes.POINTER(ctypes.c_int)]
    lib.mot3d_nms_mask.restype = i
    pp, pi = ctypes.POINTER(p), ctypes.POINTER(i)
    pf = ctypes.POINTER(f)
    lib.mot3d_roi_align_forward.argtypes = [pp, pi, pi, pf, i, i, p, p, p,
                                            i, i, i, i, i, p]
    lib.mot3d_roi_align_forward.restype = i
    lib.mot3d_roi_align_backward.argtypes = [pp, pp, pi, pi, pf, i, i, p, p,
                                             p, p, i, i, i, i, i, p]
    lib.mot3d_roi_align_backward.restype = i
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
