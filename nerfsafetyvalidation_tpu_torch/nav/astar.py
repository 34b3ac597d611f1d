"""A* on a 3-D occupancy grid (nerfsafetyvalidation_tpu/nav/astar.py with
its native search, native/lib.py `astar`): 6-connected, unit edge cost,
euclidean heuristic; an occupied start or goal raises AssertionError, an
unreachable goal ValueError (the validate CLI restarts on both).

The search is `csrc/astar.cpp`, built with g++ at first use into `_build/`
beside the package, with the JAX package's flags (-O3 -march=native), and
bound with ctypes. Among paths of equal cost the one returned depends on
the heap's order and the heuristic's rounding, so there is no second
search to fall back to: a failed build raises."""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..ops.hopper._nvcc import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "astar.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lib = None


def build():
    """Compile csrc/astar.cpp unless its library exists (keyed by the
    source's and the flags' hash); returns the library's path."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    lib = BUILD_DIR / f"astar_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.astar3d.restype = ctypes.c_int64
        lib.astar3d.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, i32p, i32p, i32p,
                                ctypes.c_int64]
        _lib = lib
    return _lib


def astar(occupied, start, goal):
    """occupied: bool [X, Y, Z]; start, goal: integer cells (x, y, z).
    Returns the path as a list of cell tuples, start and goal included."""
    occ = np.ascontiguousarray(np.asarray(occupied), dtype=np.uint8)
    for what, cell in (("start", start), ("goal", goal)):
        if occ[tuple(cell)]:
            raise AssertionError(f"{what} cell is occupied")
    lib = _load()
    sx, sy, sz = occ.shape
    s = np.asarray(start, dtype=np.int32)
    g = np.asarray(goal, dtype=np.int32)
    out = np.empty((occ.size, 3), dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.astar3d(occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    sx, sy, sz, s.ctypes.data_as(i32p),
                    g.ctypes.data_as(i32p), out.ctypes.data_as(i32p),
                    occ.size)
    if n < 0:
        raise ValueError("Failed to find path!")
    return [tuple(int(v) for v in p) for p in out[:n]]
