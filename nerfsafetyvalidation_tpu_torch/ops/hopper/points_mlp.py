"""Kernel K1: the points-in field chain of the baked student.

`fused_points_sigma_color` is the counterpart of the JAX package's Pallas
kernel of the same name (nerfsafetyvalidation_tpu/ops/pallas/render_mlp.py).
On a CUDA tensor it launches the hand-written kernel in
`csrc/points_mlp.cu` or raises; on a CPU tensor it runs the plain PyTorch
version `fused_points_sigma_color_plain`, which the tests compare with JAX.

The kernel is built at first use with `nvcc` into `_build/` beside the
package (one shared library per source hash) and bound with ctypes.
"""

import ctypes
import os  # noqa: F401  (points_mlp.os and .NVCC_FLAGS: read by tests)
from pathlib import Path

import torch

from ..freq_encoding import freq_encode
from ._nvcc import NVCC_FLAGS, WeightCache, compile_source

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "points_mlp.cu"

HIDDEN_WIDTHS = (160, 192, 256)   # the kernel's template instances
ENC_COLS = 80                           # encoding columns padded to 5 x 16
GEO, SH, COLOR, LAST_COLS = 16, 16, 64, 16

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
        fn = lib.points_mlp_forward
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _dot(h, w, dtype):
    """bf16 (or f32) operands, f32 sum: JAX's preferred_element_type=f32."""
    return torch.matmul(h.to(dtype).float(), w.to(dtype).float())


def fused_points_sigma_color_plain(x, sh, sigma_net, color_net, multires,
                                   compute_dtype=torch.bfloat16):
    """The kernel's function in plain PyTorch: frequency encoding, then the
    JAX package's `_xla_ref_deep` chain with the same rounding points.
    Returns (sigma [N] f32, rgb [N, 3] f32)."""
    h = freq_encode(x.float(), multires)
    n_sig = len(sigma_net)
    for i, w in enumerate(sigma_net):
        h = _dot(h, w, compute_dtype)
        if i != n_sig - 1:
            h = torch.relu(h)
    sigma = torch.exp(torch.clamp(h[..., 0], -15.0, 15.0))
    g = torch.cat([sh.to(compute_dtype), h[..., 1:].to(compute_dtype)], -1)
    for i, w in enumerate(color_net):
        g = _dot(g, w, compute_dtype)
        if i != len(color_net) - 1:
            g = torch.relu(g)
    return sigma, torch.sigmoid(g[..., :3])


def _prepare(sigma_net, color_net):
    """Kernel operands in bf16, padded as the TPU kernel pads them
    (render_mlp.py _fused_points): W1 to the encode block, C1 split into the
    SH rows and the geo rows behind a zero row, the last layer to a full
    fragment. Built once per set of weights."""
    return _prepared.get(list(sigma_net) + list(color_net),
                         lambda: _pad(sigma_net, color_net))


def _pad(sigma_net, color_net):
    w1, w_last = sigma_net[0], sigma_net[-1]
    hid = w1.shape[1]
    c1, c_mid, c_last = color_net[0], color_net[1:-1], color_net[-1]
    if (hid not in HIDDEN_WIDTHS or w1.shape[0] > ENC_COLS
            or len(sigma_net) < 2 or len(color_net) < 2
            or any(tuple(w.shape) != (hid, hid) for w in sigma_net[1:-1])
            or tuple(w_last.shape) != (hid, GEO)
            or tuple(c1.shape) != (SH + GEO - 1, COLOR)
            or any(tuple(w.shape) != (COLOR, COLOR) for w in c_mid)
            or tuple(c_last.shape) != (COLOR, 3)):
        raise ValueError("K1 takes a sigma net 75..80 -> H (H in "
                         f"{HIDDEN_WIDTHS}) -> ... -> 16 and a color net "
                         "31 -> 64 -> ... -> 3")
    dev, bf = w1.device, torch.bfloat16

    def padded(w, rows, cols, row0=0):
        out = torch.zeros((rows, cols), dtype=bf, device=dev)
        out[row0:row0 + w.shape[0], :w.shape[1]] = w.to(bf)
        return out

    mats = dict(
        w1=padded(w1, ENC_COLS, hid),
        wh=torch.stack([w.to(bf) for w in sigma_net[1:-1]]).contiguous()
        if len(sigma_net) > 2 else torch.zeros((1,), dtype=bf, device=dev),
        wlast=w_last.to(bf).contiguous(),
        c1s=c1[:SH].to(bf).contiguous(),
        c1g=padded(c1[SH:], GEO, COLOR, row0=1),
        cmid=torch.stack([w.to(bf) for w in c_mid]).contiguous()
        if c_mid else torch.zeros((1,), dtype=bf, device=dev),
        clast=padded(c_last, COLOR, LAST_COLS),
        hidden=hid, n_hidden=len(sigma_net) - 2, n_color_mid=len(c_mid))
    return mats


def fused_points_sigma_color(x, sh, sigma_net, color_net, multires,
                             compute_dtype=torch.bfloat16):
    """x [N, 3] positions (encoded inside the kernel), sh [N, 16] encoded
    directions; sigma_net / color_net lists of [in, out] weights.
    Returns (sigma [N] f32, rgb [N, 3] f32).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel,
    which takes x float32 and sh bfloat16, both contiguous, and bf16
    compute; anything else raises."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_points_sigma_color_plain(x, sh, sigma_net, color_net,
                                              multires, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {x.device}")
    n = x.shape[0]
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes in bfloat16 only")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be float32 [N, 3], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if sh.dtype != torch.bfloat16 or tuple(sh.shape) != (n, SH):
        raise ValueError(f"sh must be bfloat16 [N, {SH}], got {sh.dtype} "
                         f"{tuple(sh.shape)}")
    if not (x.is_contiguous() and sh.is_contiguous()):
        raise ValueError("x and sh must be contiguous")
    if sh.data_ptr() % 16:
        raise ValueError("sh must start on a 16-byte boundary")
    if 3 + 6 * multires != sigma_net[0].shape[0]:
        raise ValueError("multires does not match the first sigma layer")
    tensors = [x, sh] + list(sigma_net) + list(color_net)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, sh and the weights must be on one device")
    m = _prepare(sigma_net, color_net)
    out = torch.empty((n, 8), dtype=torch.float32, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _library().points_mlp_forward(
                x.data_ptr(), sh.data_ptr(), m["w1"].data_ptr(),
                m["wh"].data_ptr(), m["wlast"].data_ptr(),
                m["c1s"].data_ptr(), m["c1g"].data_ptr(),
                m["cmid"].data_ptr(), m["clast"].data_ptr(), out.data_ptr(),
                n, multires, m["hidden"], m["n_hidden"], m["n_color_mid"],
                stream)
        if err != 0:
            raise RuntimeError(f"points_mlp_forward launch failed: "
                               f"cudaError {err}")
        LAUNCHES += 1
    return out[:, 0], out[:, 1:4]
