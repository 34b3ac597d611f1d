"""What the kernel wrappers share: building a kernel source with `nvcc`
into a shared library, and the cache of their prepared weights.

Each source is compiled at first use into `_build/` beside the package, one
library per hash of the source, the local headers it includes (`#include
"..."`, such as csrc/sm90.cuh) and the flags, so an edited source or header
is rebuilt and an unchanged one is not. The library has a plain C interface
and is bound with ctypes by the kernel's wrapper."""

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def local_sources(source: Path):
    """`source` and every header it includes with `#include "..."`,
    directly or through another header (each path relative to the file
    that includes it), each once, in the order they are first included."""
    order, stack = [], [Path(source)]
    while stack:
        path = stack.pop()
        if path in order:
            continue
        order.append(path)
        names = _LOCAL_INCLUDE.findall(path.read_bytes())
        stack.extend(path.parent / n.decode() for n in reversed(names))
    return order


def source_digest(source: Path, flags=NVCC_FLAGS) -> str:
    """sha256 of `source`, its local headers (`local_sources`) and the
    flags: the key of its library in the build directory."""
    h = hashlib.sha256()
    for path in local_sources(source):
        data = path.read_bytes()
        h.update(f"{path.name}:{len(data)}:".encode() + data)
    h.update(" ".join(flags).encode())
    return h.hexdigest()


def compile_source(source: Path, flags=NVCC_FLAGS):
    """Compile `source` unless its library exists. Returns (library path,
    nvcc's output, empty when nothing was compiled)."""
    tag = source_digest(source, flags)
    lib = BUILD_DIR / f"{source.stem}_{tag[:16]}.so"
    if lib.exists():
        return lib, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, log


def weights_key(weights):
    """Cache key of a set of weight tensors: storage, shape and version
    (inference tensors keep no version counter, and cannot be changed in
    place outside inference mode)."""
    return tuple((w.data_ptr(), 0 if w.is_inference() else w._version,
                  tuple(w.shape)) for w in weights)


class WeightCache:
    """A kernel's operands prepared from a set of weights (cast, padded,
    packed), built once per set. An entry holds its weights, so that their
    storage, which the key names, cannot be handed to other tensors while
    the entry lives; at `size` entries the cache starts over."""

    def __init__(self, size: int = 8):
        self.size = size
        self._entries = {}

    def get(self, weights, prepare, tag=None):
        """The operands of `weights` (a list of tensors), from
        `prepare()` the first time. `tag` tells apart the operands that
        one kernel module prepares in more than one way from one set of
        weights."""
        key = (tag,) + weights_key(weights)
        hit = self._entries.get(key)
        if hit is None:
            if len(self._entries) >= self.size:
                self._entries.clear()
            hit = (tuple(weights), prepare())
            self._entries[key] = hit
        return hit[1]


def ring_grid(n: int, tile_rows: int, sms: int, per_sm: int = 1) -> int:
    """Blocks of a persistent ring kernel (K3, K4) for n rows: one per tile
    of tile_rows rows, at most the card's resident blocks (sms x
    per_sm)."""
    return min(-(-n // tile_rows), sms * per_sm)


def ring_rows(n: int, tile_rows: int, blocks: int):
    """The rows a persistent ring kernel (K3, K4) takes, in the order its
    blocks walk them: block b takes tiles b, b + blocks, b + 2 blocks, ...;
    consumer warpgroup w of a tile its rows [64 w, 64 w + 64), clipped to
    n. Yields (block, tile, first row, end row) for each warpgroup that has
    rows."""
    tiles = -(-n // tile_rows)
    for b in range(blocks):
        for t in range(b, tiles, blocks):
            for w in range(tile_rows // 64):
                start = t * tile_rows + 64 * w
                if start < n:
                    yield b, t, start, min(start + 64, n)
