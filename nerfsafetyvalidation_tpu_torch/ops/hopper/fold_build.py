"""Kernel K5: the mip-fold cell-table build, forward and backward.

`fold_build` is the counterpart of the JAX package's `fold_build_pallas`
(nerfsafetyvalidation_tpu/ops/pallas/fold_build.py), the route of
`train_gather="foldrow_pallas"`: V [(F+1)^3, Cd] -> fold [F^3, 8 * Cd],
row (x, y, z) holding the 8 corner rows V[x+bx, y+by, z+bz] (x-bit
fastest), with a backward that sums the 8 shifted cotangent slices back
into dV. It is an `autograd.Function`; each direction launches the
hand-written kernel of `csrc/fold_build.cu` on a CUDA tensor (or raises),
and runs its plain PyTorch version on a CPU tensor:

* `fold_build_plain`: the slice-stack (`build_mip_fold_table` folds
  through it too);
* `fold_build_bwd_plain`: the TPU kernel's backward with its rounding (the
  bx = 0 and bx = 1 corners summed apart in f32, each rounded to the
  output dtype, then added in it).

The kernel moves 16-byte chunks, so on the card a row of Cd values must be
a whole number of them (Cd a multiple of 8 in bf16, of 4 in f32; the
teacher's Cd is 16). It is built at first use with `nvcc` into `_build/`
beside the package and bound with ctypes.
"""

import ctypes
from pathlib import Path

import torch

from ..hash_encoding import _corner_bits
from ._nvcc import compile_source

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "fold_build.cu"

# corner k = bx + 2 by + 4 bz, x-bit fastest
_BITS = _corner_bits(3).astype(int).tolist()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernels since the last reset (never the plain path):
# the forward, and the backward
LAUNCHES = 0
LAUNCHES_BWD = 0
# nvcc's report (registers, shared memory, spills) of the last build
BUILD_LOG = ""

_lib = None


def build() -> Path:
    """Compile the kernels if their library for this source is missing;
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
        for fn in (lib.fold_build_forward, lib.fold_build_backward):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] \
                + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def fold_build_plain(V, F: int, Cd: int):
    """V [(F+1)^3, Cd] -> fold [F^3, 8 * Cd]: the slice-stack."""
    V4 = V.reshape(F + 1, F + 1, F + 1, Cd)
    corners = [V4[bx:bx + F, by:by + F, bz:bz + F] for bx, by, bz in _BITS]
    return torch.stack(corners, dim=3).reshape(F ** 3, 8 * Cd)


def fold_build_bwd_plain(ct, F: int, Cd: int):
    """ct [F^3, 8 * Cd] -> dV [(F+1)^3, Cd] in ct's dtype, rounded as the
    TPU kernel's backward rounds (fold_build.py `_bwd_kernel`)."""
    ct5 = ct.reshape(F, F, F, 8, Cd)
    halves = []
    for half in (0, 1):
        acc = torch.zeros((F + 1, F + 1, F + 1, Cd), dtype=torch.float32,
                          device=ct.device)
        for k, (bx, by, bz) in enumerate(_BITS):
            if bx == half:
                acc[bx:bx + F, by:by + F, bz:bz + F] += ct5[:, :, :, k].float()
        halves.append(acc.to(ct.dtype))
    return (halves[0] + halves[1]).reshape((F + 1) ** 3, Cd)


def _launch(name, src, out, F: int, Cd: int):
    if src.dtype not in _DTYPES:
        raise ValueError(f"K5 takes float32 or bfloat16, not {src.dtype}")
    if not src.is_contiguous():
        raise ValueError("K5 takes a contiguous tensor")
    if (Cd * src.element_size()) % 16 or src.data_ptr() % 16 \
            or out.data_ptr() % 16:
        raise ValueError(f"K5 moves 16-byte chunks: a row of {Cd} "
                         f"{src.dtype} values is not whole chunks, or a "
                         "pointer is not 16-byte aligned")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = getattr(_library(), name)(src.data_ptr(), out.data_ptr(), F,
                                        Cd, _DTYPES[src.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check(t, shape, what):
    if tuple(t.shape) != shape:
        raise ValueError(f"K5 {what} must be {shape}, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K5 runs on CUDA or CPU tensors, not {t.device}")


def fold_build_forward(V, F: int, Cd: int):
    """V [(F+1)^3, Cd] -> fold [F^3, 8 * Cd] in V's dtype (no autograd)."""
    global LAUNCHES
    _check(V, ((F + 1) ** 3, Cd), "V")
    if V.device.type == "cpu":
        return fold_build_plain(V, F, Cd)
    out = torch.empty((F ** 3, 8 * Cd), dtype=V.dtype, device=V.device)
    _launch("fold_build_forward", V, out, F, Cd)
    LAUNCHES += 1
    return out


def fold_build_backward(ct, F: int, Cd: int):
    """ct [F^3, 8 * Cd] -> dV [(F+1)^3, Cd] in ct's dtype (no autograd)."""
    global LAUNCHES_BWD
    _check(ct, (F ** 3, 8 * Cd), "cotangent")
    if ct.device.type == "cpu":
        return fold_build_bwd_plain(ct, F, Cd)
    out = torch.empty(((F + 1) ** 3, Cd), dtype=ct.dtype, device=ct.device)
    _launch("fold_build_backward", ct, out, F, Cd)
    LAUNCHES_BWD += 1
    return out


class FoldBuild(torch.autograd.Function):
    @staticmethod
    def forward(ctx, V, F, Cd):
        ctx.F, ctx.Cd = F, Cd
        return fold_build_forward(V, F, Cd)

    @staticmethod
    def backward(ctx, ct):
        return fold_build_backward(ct.contiguous(), ctx.F, ctx.Cd), None, None


def fold_build(V, F: int, Cd: int):
    """V [(F+1)^3, Cd] -> fold table [F^3, 8 * Cd], differentiable: each
    direction through K5 on a CUDA tensor, its plain version on a CPU
    tensor."""
    return FoldBuild.apply(V, F, Cd)
