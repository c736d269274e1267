"""Build and load the native host libraries.

`native/rle/rle.cpp` (the COCO RLE codec) and `native/voxelize/
voxelize.cpp` (the mesh voxelizer and point-in-mesh test) are compiled
with `g++ -O3 -fPIC -shared -std=c++17` into `build/native/lib<name>.so`
at the root of the checkout, at first use, and loaded with ctypes.  The
`.so` files committed under `native/lib/` are not loaded: they were built
for another toolchain.  A build is keyed on a hash of its source, flags
and compiler version and runs under a file lock, so concurrent processes
build once (`locked_build`, shared with the CUDA kernels'
`ops/cuda/build.py`).  A failed build raises with the compiler's output;
nothing falls back to the numpy versions on its own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBRARIES = ("rle", "voxelize")


def source_key(flags: Sequence[str], sources: Sequence[Path]) -> str:
    """The hash a build is keyed on: its flags and its sources' bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def run_all(cmds) -> str:
    """Start every command at once; return their combined output, or raise
    with the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"build failed: {' '.join(cmd)}\n{out}")
    return "".join(outputs)


def locked_build(lib: Path, key: str,
                 make: Callable[[Path], str]) -> Optional[str]:
    """Build `lib` unless a library stamped with `key` is there already:
    `make(tmp)` writes the library to `tmp` and returns the build's log,
    and `tmp` then replaces `lib`.  Runs under a lock file in `lib`'s
    directory.  Returns the log, or None when nothing was built."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    stamp = lib.with_name(lib.name + ".sha256")
    with open(lib.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists() and stamp.exists() and stamp.read_text() == key:
            return None
        tmp = lib.with_name(lib.name + f".tmp{os.getpid()}")
        log = make(tmp)
        os.replace(tmp, lib)
        stamp.write_text(key)
        return log


@dataclasses.dataclass(frozen=True)
class NativeBuild:
    path: Path
    seconds: float
    cached: bool


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found (set CXX); the native libraries "
                           f"are built from {NATIVE_SRC} on first use")
    return found


def build(name: str) -> NativeBuild:
    """Compile `native/<name>/<name>.cpp` unless it is built already."""
    if name not in LIBRARIES:
        raise ValueError(f"no native library {name!r}; one of {LIBRARIES}")
    src = NATIVE_SRC / name / f"{name}.cpp"
    lib = BUILD_DIR / f"lib{name}.so"
    t0 = time.perf_counter()
    cxx = _cxx()
    # The compiler's version is part of the key: a checkout copied to
    # another machine rebuilds with that machine's toolchain.
    version = run_all([[cxx, "--version"]]).splitlines()[:1]
    log = locked_build(lib, source_key((*CXX_FLAGS, *version), [src]),
                       lambda tmp: run_all(
                           [[cxx, *CXX_FLAGS, str(src), "-o", str(tmp)]]))
    return NativeBuild(lib, time.perf_counter() - t0, log is None)


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The built library `name`, loaded once per process."""
    return ctypes.CDLL(str(build(name).path))
