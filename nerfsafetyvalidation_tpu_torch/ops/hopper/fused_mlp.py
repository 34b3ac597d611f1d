"""Kernel K4: a bias-free ReLU MLP of any depth, all layers in one launch.

`fused_mlp` is the counterpart of the JAX package's Pallas kernel of the
same name (nerfsafetyvalidation_tpu/ops/pallas/fused_mlp.py), which the
hash-grid field's `density` and `color` run when `cfg.fused` is set. On a
CUDA tensor it launches the hand-written kernel in `csrc/fused_mlp.cu` or
raises; on a CPU tensor it runs the plain PyTorch version
`fused_mlp_plain`, which the tests compare with JAX.

Both round every layer's output to the compute dtype, the last layer too,
as the TPU kernel does (the JAX package's unfused chain keeps the last
layer in float32).

The kernel is built at first use with `nvcc` into `_build/` beside the
package and bound with ctypes.
"""

import ctypes
from pathlib import Path

import torch

from ._nvcc import WeightCache, compile_source, refuse_grad
from .points_mlp import _dot

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "fused_mlp.cu"

MAX_LAYERS = 8        # the kernel's caps (csrc/fused_mlp.cu)
MAX_WIDTH = 128
MAX_SMEM = 232448     # bytes of shared memory a block may use on sm_90
WARPS = 4

# launches of the CUDA kernel since the last reset (never the plain path)
LAUNCHES = 0
# nvcc's report (registers, shared memory, spills) of the last build
BUILD_LOG = ""

_lib = None
_prepared = WeightCache()


def build() -> Path:
    """Compile the kernel if its library for this source is missing;
    returns the library's path."""
    global BUILD_LOG
    lib, log = compile_source(SOURCE)
    if log:
        BUILD_LOG = log
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.fused_mlp_forward
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused_mlp_plain(x, weights, compute_dtype=torch.bfloat16):
    """The kernel's function in plain PyTorch: operands rounded to
    `compute_dtype`, f32 sums, ReLU between layers, every layer's output
    rounded to `compute_dtype`. x [N, D_0]; weights [in, out] each.
    Returns [N, D_L] f32."""
    h = x
    for i, w in enumerate(weights):
        h = _dot(h, w, compute_dtype)
        if i != len(weights) - 1:
            h = torch.relu(h)
        h = h.to(compute_dtype).float()
    return h


def _pad16(v):
    return (v + 15) // 16 * 16


def _smem_bytes(widths):
    """Shared memory of one block (csrc/fused_mlp.cu smem_bytes)."""
    w_elems = sum(_pad16(a) * _pad16(b) for a, b in zip(widths, widths[1:]))
    pitch = max(16, *(_pad16(v) for v in widths)) + 8
    return 2 * w_elems + WARPS * 2 * 16 * pitch * 2 + WARPS * 256 * 4


def _widths(weights):
    """[D_0, ..., D_L] of a chain of [in, out] weights; raises for a chain
    that does not link up or that the kernel does not take."""
    widths = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    if any(w.ndim != 2 or w.shape[0] != widths[i]
           for i, w in enumerate(weights)):
        raise ValueError(f"weights {[tuple(w.shape) for w in weights]} do "
                         "not chain")
    if not (1 <= len(weights) <= MAX_LAYERS
            and max(widths) <= MAX_WIDTH
            and _smem_bytes(widths) <= MAX_SMEM):
        raise ValueError(f"K4 takes 1..{MAX_LAYERS} layers of widths up to "
                         f"{MAX_WIDTH} whose padded weights fit a block's "
                         f"shared memory, got widths {widths}")
    return widths


def _prepare(weights):
    """(widths, packed weights): every layer zero-padded to [16k, 16m]
    bf16 and all of them in one contiguous buffer, built once per set of
    weights."""
    return _prepared.get(list(weights), lambda: _pack(weights))


def _pack(weights):
    widths = _widths(weights)
    parts = []
    for w in weights:
        p = torch.zeros((_pad16(w.shape[0]), _pad16(w.shape[1])),
                        dtype=torch.bfloat16, device=w.device)
        p[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
        parts.append(p.reshape(-1))
    return widths, torch.cat(parts).contiguous()


def fused_mlp(x, weights, compute_dtype=torch.bfloat16):
    """Bias-free ReLU MLP over x [N, D_0] with weights [in, out] each;
    returns [N, D_L] f32, every layer rounded to `compute_dtype`.

    A CPU tensor takes the plain version, under autograd. A CUDA tensor
    launches the kernel, which computes in bfloat16 only and takes at most
    MAX_LAYERS layers of widths up to MAX_WIDTH; x is cast to bfloat16 and
    must then be contiguous and start on a 16-byte boundary. It has no
    backward yet: where autograd would need one, and for anything else, it
    raises."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_mlp_plain(x, weights, compute_dtype)
    refuse_grad("K4", [x, *weights])
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {x.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes in bfloat16 only")
    if any(w.device != x.device for w in weights):
        raise ValueError("x and the weights must be on one device")
    widths, packed = _prepare(weights)
    n = x.shape[0]
    if x.ndim != 2 or x.shape[1] != widths[0]:
        raise ValueError(f"x must be [N, {widths[0]}], got "
                         f"{tuple(x.shape)}")
    x = x.to(torch.bfloat16)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and start on a 16-byte "
                         "boundary")
    out = torch.empty((n, widths[-1]), dtype=torch.float32, device=x.device)
    if n:
        dims = (ctypes.c_int * len(widths))(*widths)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _library().fused_mlp_forward(
                x.data_ptr(), packed.data_ptr(), dims, len(weights),
                out.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"fused_mlp_forward launch failed: "
                               f"cudaError {err}")
        LAUNCHES += 1
    return out
