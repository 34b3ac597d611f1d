"""Kernels K1 and K2: the field chain of the baked student, from sample
positions (K1) or from a precomputed encoding (K2).

`fused_points_sigma_color` (K1) and `fused_sigma_color_deep` (K2) are the
counterparts of the JAX package's Pallas kernels of the same names
(nerfsafetyvalidation_tpu/ops/pallas/render_mlp.py). On a CUDA tensor each
launches its hand-written kernel in `csrc/points_mlp.cu` or raises; on a
CPU tensor each runs its plain PyTorch version
(`fused_points_sigma_color_plain`, `fused_sigma_color_deep_plain`), which
the tests compare with JAX. K2 is K1's kernel reading the encoding in
place of building it, in either dtype. In float32 the kernel runs on the
tensor cores as 3xTF32 (csrc/sm90.cuh: each operand split into tf32 hi and
lo, three products a term, f32 sums), as K4's f32 kernel does;
`fused_sigma_color_deep_tf32_emulated` is its arithmetic in plain PyTorch.

Both are differentiable, as the JAX functions are: on the card through
`_Chain`, an autograd Function whose forward launches the kernel and whose
backward recomputes the plain chain under autograd (the JAX package's
`_fused_points_bwd` and `_fused_deep_bwd` recompute through `_xla_ref_deep`;
neither TPU kernel has a backward kernel).

The kernels are built at first use with `nvcc` into `_build/` beside the
package (one shared library per source hash) and bound with ctypes. Their
weights come as one packed image per set of weights and dtype
(`_prepare`): in bfloat16 the shared-memory image that `wgmma` reads as
its B operand, which the kernel streams through a ring of stages with bulk
copies; in float32 the layers as hi and lo tf32 B images, each k-step's
rows in K_ORDER, cut into the f32 ring's chunks (`tf32_layers`,
`pack_image_tf32`), and C_last as its exact f32 weights.
"""

import ctypes
import os  # noqa: F401  (points_mlp.os and .NVCC_FLAGS: read by tests)
from pathlib import Path

import torch

from ..freq_encoding import freq_encode
from ._nvcc import NVCC_FLAGS, WeightCache, compile_source
from .fused_mlp import FMA_OUT
from .wgmma_image import dot, tf32_chunks, tf32_dot, wgmma_b

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "points_mlp.cu"

HIDDEN_WIDTHS = (160, 192, 256)   # the kernel's template instances
ENC_COLS = 80                           # encoding columns padded to 5 x 16
GEO, SH, COLOR, LAST_COLS = 16, 16, 64, 16
# The bf16 image's layout, as csrc/points_mlp.cu's descriptors state it:
# K-major, no swizzle, 8 x 8 core matrices of 128 contiguous bytes; the two
# 8-deep halves of a 16-deep k-step B_LBO bytes apart, neighbouring
# 8-column groups B_SBO bytes apart; k-steps one after another.
B_LBO, B_SBO = 128, 256
# the bf16 kernel's weight ring per hidden width (csrc/points_mlp.cu
# Ring<H>): k-steps of a hidden layer per chunk, bytes of a stage, stages;
# before the ring, its barriers and each consumer warpgroup's bf16
# encoding tile (64 rows of 80 + 8 columns) and f32 positions (64 x 3)
RING = {160: (5, 32768, 6), 192: (6, 36864, 5), 256: (4, 40960, 5)}
RING_BARRIER_BYTES = 128
RING_OFFSET = RING_BARRIER_BYTES + 2 * (64 * (ENC_COLS + 8) * 2 + 64 * 3 * 4)
# the f32 kernel's weight ring per hidden width (csrc/points_mlp.cu
# RingF32<H>): column parts of a hidden layer, bytes of a stage (one chunk
# of an H-wide layer: 128 H), stages
RING_F32 = {160: (1, 20480, 8), 192: (1, 24576, 7), 256: (2, 32768, 5)}
# what each dtype's image holds (the weight cache's tag: one set of weights
# packed two ways must never be taken for the other)
LAYOUT = {torch.bfloat16: "wgmma-B-kmajor-noswizzle",
          torch.float32: "tf32-hi-lo-korder-chunks"}

# launches of each CUDA kernel since the last reset (never the plain path):
# K1's in bf16 by the sigma net's hidden width (their sum is K1's count),
# K1's in float32, and K2's in either dtype; and the calls of the plain
# chain (K1's and K2's)
LAUNCHES_BY_WIDTH = {}
LAUNCHES_F32 = 0
LAUNCHES_DEEP = 0
PLAIN_CALLS = 0
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
        for name in ("points_mlp_forward", "points_mlp_forward_f32",
                     "deep_mlp_forward", "deep_mlp_forward_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] \
                + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused_sigma_color_deep_plain(enc, sh, sigma_net, color_net,
                                 compute_dtype=torch.bfloat16):
    """K2's function in plain PyTorch: the JAX package's `_xla_ref_deep`
    chain with the same rounding points. enc [N, D_enc], sh [N, 16].
    Returns (sigma [N] f32, rgb [N, 3] f32)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    h = enc
    n_sig = len(sigma_net)
    for i, w in enumerate(sigma_net):
        h = dot(h, w, compute_dtype)
        if i != n_sig - 1:
            h = torch.relu(h)
    sigma = torch.exp(torch.clamp(h[..., 0], -15.0, 15.0))
    g = torch.cat([sh.to(compute_dtype), h[..., 1:].to(compute_dtype)], -1)
    for i, w in enumerate(color_net):
        g = dot(g, w, compute_dtype)
        if i != len(color_net) - 1:
            g = torch.relu(g)
    return sigma, torch.sigmoid(g[..., :3])


def fused_sigma_color_deep_tf32_emulated(enc, sh, sigma_net, color_net,
                                         products=3):
    """The float32 kernel's arithmetic in plain PyTorch: every layer but
    C_last as three tf32 products a term summed in f32
    (`wgmma_image.tf32_dot`; `products` 2 or 1 leave products out, which
    the kernel does not), C_last (3 columns, the kernel's FFMA) in f32;
    C1's input [sh | s] with C1g's zero row taking s0, as the kernel does.
    Returns (sigma [N], rgb [N, 3])."""
    h = enc.float()
    for i, w in enumerate(sigma_net):
        h = tf32_dot(h, w.float(), products)
        if i != len(sigma_net) - 1:
            h = torch.relu(h)
    sigma = torch.exp(torch.clamp(h[..., 0], -15.0, 15.0))
    c1 = color_net[0].float()
    c1 = torch.cat([c1[:SH], torch.zeros_like(c1[:1]), c1[SH:]])
    g = torch.cat([sh.float(), h], -1)
    for i, w in enumerate([c1] + list(color_net[1:])):
        g = tf32_dot(g, w.float(), products) if i != len(color_net) - 1 \
            else g @ w.float()
        if i != len(color_net) - 1:
            g = torch.relu(g)
    return sigma, torch.sigmoid(g)


def fused_points_sigma_color_plain(x, sh, sigma_net, color_net, multires,
                                   compute_dtype=torch.bfloat16):
    """K1's function in plain PyTorch: the frequency encoding, then K2's
    plain chain. Returns (sigma [N] f32, rgb [N, 3] f32)."""
    return fused_sigma_color_deep_plain(freq_encode(x.float(), multires), sh,
                                        sigma_net, color_net, compute_dtype)


def _prepare(sigma_net, color_net, dtype=torch.bfloat16):
    """Kernel operands in `dtype` (bf16: K1 and K2; float32: K2's f32
    kernel), padded as the TPU kernel pads them (render_mlp.py
    _fused_points): W1 to the encode block, C1 split into the SH rows and
    the geo rows behind a zero row, the last layer to a full fragment; and
    `image`, those layers packed for the kernel (`pack_image`). Built once
    per set of weights and layout."""
    def pad():
        with torch.no_grad():
            return _pad(sigma_net, color_net, dtype)

    return _prepared.get(list(sigma_net) + list(color_net), pad,
                         tag=f"{dtype}/{LAYOUT[dtype]}")


def tail_bytes(hidden, n_color_mid):
    """Bytes of the bf16 image's last chunk: W_L, C1 and the color net."""
    return (hidden // 16) * 32 * GEO + 2 * 32 * COLOR \
        + n_color_mid * 4 * 32 * COLOR + 4 * 32 * LAST_COLS


def image_layers(m):
    """The padded layers of `_pad`'s operands, in the image's order: W1,
    the hidden layers, W_L, C1 = [C1s; C1g], the middle color layers,
    C_last; each [in, out]."""
    return ([m["w1"]] + list(m["wh"][:m["n_hidden"]]) + [m["wlast"]]
            + [torch.cat([m["c1s"], m["c1g"]])]
            + list(m["cmid"][:m["n_color_mid"]]) + [m["clast"]])


def pack_image(m, dtype):
    """The kernel's one weight operand: in bf16 the layers of
    `image_layers`, one after another, in wgmma's B layout; in float32
    `pack_image_tf32`."""
    if dtype == torch.float32:
        return pack_image_tf32(m)
    return torch.cat([wgmma_b(w) for w in image_layers(m)]).contiguous()


def tf32_layers(m):
    """The f32 image's layers in the order the kernel streams them, each
    (weights [in, out], column parts, k-steps a chunk): W1 in chunks of 2
    k-steps; each hidden layer in RING_F32's parts, chunks of 2 k-steps a
    part; W_L whole; C1 and the middle color layers in chunks of 4
    k-steps; and last C_last's first FMA_OUT columns (f32, the FFMA
    layer), with parts and k-steps None. Every chunk of an H-wide layer is
    one stage of the ring, 128 H bytes."""
    layers = image_layers(m)
    hid, n_hidden = m["hidden"], m["n_hidden"]
    parts = RING_F32[hid][0]
    plan = ([(1, 2)] + [(parts, 2 * parts)] * n_hidden + [(1, hid // 8)]
            + [(1, 4)] * (1 + m["n_color_mid"]))
    return [(w, p, k) for w, (p, k) in zip(layers[:-1], plan)] + [
        (layers[-1][:, :FMA_OUT], None, None)]


def pack_image_tf32(m):
    """The f32 kernel's one weight operand: every layer of `tf32_layers`
    but the last as `wgmma_image.tf32_chunks` (each chunk its hi, then its lo
    tf32 B image, each k-step's rows in K_ORDER), C_last's f32 weights
    row-major, one after another."""
    parts = []
    for w, p, k in tf32_layers(m):
        parts += [w.reshape(-1)] if p is None else tf32_chunks(w, k, p)
    return torch.cat(parts).contiguous()


def f32_stream_bytes(hidden, n_hidden, n_color_mid):
    """Bytes of the f32 image, which every 128-row tile of the f32 kernel
    streams from L2: 8 a multiply-add of the padded layers, and C_last's
    [64, FMA_OUT] f32."""
    macs = ENC_COLS * hidden + n_hidden * hidden * hidden + hidden * GEO \
        + (SH + GEO) * COLOR + n_color_mid * COLOR * COLOR
    return 8 * macs + 4 * COLOR * FMA_OUT


def _pad(sigma_net, color_net, dtype=torch.bfloat16):
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
        raise ValueError("K1 and K2 take a sigma net 1..80 -> H (H in "
                         f"{HIDDEN_WIDTHS}) -> ... -> 16 and a color net "
                         "31 -> 64 -> ... -> 3")
    dev = w1.device

    def padded(w, rows, cols, row0=0):
        out = torch.zeros((rows, cols), dtype=dtype, device=dev)
        out[row0:row0 + w.shape[0], :w.shape[1]] = w.to(dtype)
        return out

    mats = dict(
        w1=padded(w1, ENC_COLS, hid),
        wh=torch.stack([w.to(dtype) for w in sigma_net[1:-1]]).contiguous()
        if len(sigma_net) > 2 else torch.zeros((1,), dtype=dtype, device=dev),
        wlast=w_last.to(dtype).contiguous(),
        c1s=c1[:SH].to(dtype).contiguous(),
        c1g=padded(c1[SH:], GEO, COLOR, row0=1),
        cmid=torch.stack([w.to(dtype) for w in c_mid]).contiguous()
        if c_mid else torch.zeros((1,), dtype=dtype, device=dev),
        clast=padded(c_last, COLOR, LAST_COLS),
        hidden=hid, n_hidden=len(sigma_net) - 2, n_color_mid=len(c_mid))
    if dtype == torch.bfloat16 and \
            tail_bytes(hid, len(c_mid)) > RING[hid][1]:
        raise ValueError(f"the bf16 kernel's last chunk (W_L and the color "
                         f"net) outgrows its {RING[hid][1]}-byte stage: at "
                         f"most {(RING[hid][1] - tail_bytes(hid, 0)) // 8192}"
                         f" middle color layers at H = {hid}")
    mats["image"] = pack_image(mats, dtype)
    return mats


class _Chain(torch.autograd.Function):
    """out = launch(*args) on the card, [N, >= 4] f32 with sigma in column
    0 and rgb in 1..3; the backward recomputes plain(*args) -> (sigma, rgb)
    under autograd and takes its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, launch, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return launch(*args)

    @staticmethod
    def backward(ctx, g_out):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [a.detach().requires_grad_(n)
                    for a, n in zip(ctx.saved_tensors, need)]
            sigma, rgb = ctx.plain(*args)
            wrt = [a for a, n in zip(args, need) if n]
            grads = iter(torch.autograd.grad(
                (sigma, rgb), wrt, (g_out[:, 0], g_out[:, 1:4]),
                allow_unused=True))
        return (None, None) + tuple(next(grads) if n else None
                                    for n in need)


def _split(args, n_sig):
    """(first, sh, sigma_net, color_net) of _Chain's args."""
    weights = args[2:]
    return args[0], args[1], list(weights[:n_sig]), list(weights[n_sig:])


def _check_sh(sh, n, dtype):
    if sh.dtype != dtype or tuple(sh.shape) != (n, SH):
        raise ValueError(f"sh must be {dtype} [N, {SH}], got {sh.dtype} "
                         f"{tuple(sh.shape)}")


def _run(name, first, sh, sigma_net, color_net, dtype, out_cols, *ints):
    """Launches `name` on (first, sh) with the weights prepared in `dtype`;
    returns out [N, out_cols] f32."""
    tensors = [first, sh] + list(sigma_net) + list(color_net)
    if any(t.device != first.device for t in tensors):
        raise ValueError("the inputs and the weights must be on one device")
    if not (first.is_contiguous() and sh.is_contiguous()):
        raise ValueError("the inputs must be contiguous")
    if sh.data_ptr() % 16:
        raise ValueError("sh must start on a 16-byte boundary")
    m = _prepare(sigma_net, color_net, dtype)
    n = first.shape[0]
    out = torch.empty((n, out_cols), dtype=torch.float32, device=first.device)
    if n:
        with torch.cuda.device(first.device):
            stream = torch.cuda.current_stream(first.device).cuda_stream
            err = getattr(_library(), name)(
                first.data_ptr(), sh.data_ptr(), m["image"].data_ptr(),
                out.data_ptr(), n, *ints, m["hidden"], m["n_hidden"],
                m["n_color_mid"], stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def fused_points_sigma_color(x, sh, sigma_net, color_net, multires,
                             compute_dtype=torch.bfloat16):
    """x [N, 3] positions (encoded inside the kernel), sh [N, 16] encoded
    directions; sigma_net / color_net lists of [in, out] weights.
    Returns (sigma [N] f32, rgb [N, 3] f32), differentiable.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    of `compute_dtype` (bfloat16 or float32), which takes x float32 and sh
    in the compute dtype, both contiguous, sh on a 16-byte boundary;
    anything else raises."""
    if x.device.type == "cpu":
        return fused_points_sigma_color_plain(x, sh, sigma_net, color_net,
                                              multires, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {x.device}")
    n = x.shape[0]
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K1 computes in bfloat16 or float32, not "
                         f"{compute_dtype}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be float32 [N, 3], got {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_sh(sh, n, compute_dtype)
    if 3 + 6 * multires != sigma_net[0].shape[0]:
        raise ValueError("multires does not match the first sigma layer")
    n_sig = len(sigma_net)
    hidden = sigma_net[0].shape[1]
    f32 = compute_dtype == torch.float32

    def launch(*args):
        global LAUNCHES_F32
        out = _run("points_mlp_forward_f32" if f32 else "points_mlp_forward",
                   *_split(args, n_sig), compute_dtype, 4 if f32 else 8,
                   multires)
        if n and f32:
            LAUNCHES_F32 += 1
        elif n:
            LAUNCHES_BY_WIDTH[hidden] = LAUNCHES_BY_WIDTH.get(hidden, 0) + 1
        return out

    def plain(*args):
        x_, sh_, sn, cn = _split(args, n_sig)
        return fused_points_sigma_color_plain(x_, sh_, sn, cn, multires,
                                              compute_dtype)

    out = _Chain.apply(launch, plain, x, sh, *sigma_net, *color_net)
    return out[:, 0], out[:, 1:4]


def fused_sigma_color_deep(enc, sh, sigma_net, color_net,
                           compute_dtype=torch.bfloat16):
    """enc [N, D_enc <= 80] encoded positions, sh [N, 16] encoded
    directions; sigma_net D_enc -> H -> ... -> 16 (H in HIDDEN_WIDTHS),
    color_net 31 -> 64 -> ... -> 3, lists of [in, out] weights. Returns
    (sigma [N] f32, rgb [N, 3] f32), differentiable.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    of `compute_dtype` (bfloat16 or float32): enc and sh are cast to it and
    must then be contiguous, sh (and enc in bfloat16) on a 16-byte
    boundary; anything else raises."""
    if enc.device.type == "cpu":
        return fused_sigma_color_deep_plain(enc, sh, sigma_net, color_net,
                                            compute_dtype)
    if enc.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {enc.device}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K2 computes in bfloat16 or float32, not "
                         f"{compute_dtype}")
    n = enc.shape[0]
    if enc.dim() != 2 or enc.shape[1] != sigma_net[0].shape[0]:
        raise ValueError(f"enc must be [N, {sigma_net[0].shape[0]}], got "
                         f"{tuple(enc.shape)}")
    enc, sh = enc.to(compute_dtype), sh.to(compute_dtype)
    _check_sh(sh, n, compute_dtype)
    if compute_dtype == torch.bfloat16 and enc.data_ptr() % 16:
        raise ValueError("enc must start on a 16-byte boundary: the bf16 "
                         "kernel reads its rows with 16-byte loads")
    name = "deep_mlp_forward" if compute_dtype == torch.bfloat16 \
        else "deep_mlp_forward_f32"
    n_sig = len(sigma_net)

    def launch(*args):
        global LAUNCHES_DEEP
        out = _run(name, *_split(args, n_sig), compute_dtype, 4,
                   enc.shape[1])
        if n:
            LAUNCHES_DEEP += 1
        return out

    def plain(*args):
        return fused_sigma_color_deep_plain(*_split(args, n_sig),
                                            compute_dtype)

    out = _Chain.apply(launch, plain, enc, sh, *sigma_net, *color_net)
    return out[:, 0], out[:, 1:4]
