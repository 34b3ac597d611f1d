"""What the kernel wrappers share: building a kernel source with `nvcc`
into a shared library, and the cache of their prepared weights.

Each source is compiled at first use into `_build/` beside the package, one
library per hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is not. The library has a plain C interface
and is bound with ctypes by the kernel's wrapper."""

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

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


def compile_source(source: Path, flags=NVCC_FLAGS):
    """Compile `source` unless its library exists. Returns (library path,
    nvcc's output, empty when nothing was compiled)."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
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


def refuse_grad(kernel: str, tensors):
    """Raises where autograd would need the backward of `kernel`, which the
    port has not written: its wrapper returns a fresh tensor without a
    gradient function, so the gradient would be lost without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} has no backward on the card yet: call "
                           "it under torch.no_grad() or inference_mode(), "
                           "or with inputs that do not require grad")


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
