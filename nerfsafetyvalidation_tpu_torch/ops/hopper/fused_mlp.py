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
package and bound with ctypes. Its weights are one operand: every layer,
zero-padded to [16k, 16m], packed once per set of weights into the
shared-memory image that `wgmma` reads as its B operand
(`wgmma_image.wgmma_b`), the layers one after another; each block of the
kernel loads it whole, and the rows of x stream through a ring of bulk
copies (csrc/fused_mlp.cu, `_plan`).

With compute_dtype float32 (the JAX package's default) a CUDA tensor
launches the library's second kernel, `fused_mlp_tf32_kernel`: f32 operands,
every layer kept in f32, on the tensor cores as 3xTF32 (each operand split
into two tf32 values, `tf32_split`; three products each, f32 sums), and a
last layer at most FMA_OUT wide as f32 FFMA on the CUDA cores
(`fused_mlp_tf32_emulated` is that arithmetic in plain PyTorch). Its
weights are split and packed once per set (`_f32_layers`, `_pack_f32`):
every tensor-core layer zero-padded to [K_l, N_l] (the hash-grid nets'
widths rounded up to powers of two of at least 8, any other chain's to 64
or 128) as a hi and a lo tf32 B image
(`wgmma_b_tf32`, each k-step's rows in K_ORDER), the FFMA layer as its
exact f32 weights [K_l, FMA_OUT], one layer after another; a block keeps
them in shared memory where they fit beside its ring of x tiles, else
loads one layer at a time (`_plan_f32`).

Grouped mode, `fused_mlp_grouped`: G independent MLPs in one launch, x
[G, N, D_0] with one weight set [G, in, out] per group, what the JAX
package's kernel computes under `jax.vmap` over the weights (its batching
rule adds a leading grid axis). The in-scan Laplace fits of the batched
rollouts (validation/batched.py `_laplace_uq`) run one sigma net per sim
through it. bf16 only; the weights change at every step of a fit, so no
image is cached or written to device memory: each block of the one launch
reads its group's f32 layers through their strides (the fits' weights are
views of their flat vectors) and rounds them into its own shared memory as
`_pack` lays them out (`grouped_image_mirror` is that index map in
Python). Its plain version is `fused_mlp_grouped_plain` (the batched
products of `fused_mlp_reference`), and its backward the same recompute as
the single mode's.

Gradients (both dtypes, and on the CPU too): `fused_mlp` is an autograd
Function whose forward launches the kernel (the plain version on a CPU
tensor) and whose backward is the vector-Jacobian product of
`fused_mlp_reference`, recomputed under autograd: the JAX package's
`_xla_mlp`, whose VJP its `custom_vjp` takes (`_fused_bwd`), with the
compute dtype's operands, f32 sums and the last layer kept in f32. Its
casts round each cotangent to the compute dtype where JAX's `astype` VJP
does. The weight cache is keyed by each weight's version as well as its
storage, so an optimizer's in-place update repacks the kernel's image
before the next launch.
"""

import ctypes
import re
from pathlib import Path

import torch

from ._nvcc import WeightCache, compile_source
from .wgmma_image import (K_ORDER, dot, tf32_chunks, tf32_dot, tf32_round,
                          tf32_split, wgmma_b, wgmma_b_tf32)

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "fused_mlp.cu"

MAX_LAYERS = 8        # the kernel's caps (csrc/fused_mlp.cu)
MAX_WIDTH = 128
MAX_SMEM = 232448     # bytes of shared memory a block may use on sm_90
# the kernel's launch: consumer warpgroups of 64 rows a block, rows a tile,
# most stages of the row ring, bytes of its barriers
CONSUMERS = 2
TILE_ROWS = 64 * CONSUMERS
MAX_STAGES = 6
BARRIER_BYTES = 128
MAX_STAGES_F32 = 4    # the f32 kernel's ring
# the f32 kernel: a last layer at most FMA_OUT wide runs as FFMA; consumer
# warpgroups of 64 rows a block, in the build for widths up to 64 (the
# build for 128 has one), as the source defines them
FMA_OUT = 4
F32_CONSUMERS = int(re.search(r"constexpr int kF32Consumers = (\d+);",
                              SOURCE.read_text()).group(1))

# launches of the CUDA kernels since the last reset (never the plain
# path): the bf16 kernel, the f32 one, and the grouped mode; and the calls
# of the plain versions (single, grouped)
LAUNCHES = 0
LAUNCHES_F32 = 0
LAUNCHES_GROUPED = 0
PLAIN_CALLS = 0
PLAIN_CALLS_GROUPED = 0
MAX_GROUPS = 65535    # the grid's y extent
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
        lib.fused_mlp_plan.argtypes = [ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.fused_mlp_plan.restype = ctypes.c_int
        lib.fused_mlp_forward_grouped.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p]
        lib.fused_mlp_forward_grouped.restype = ctypes.c_int
        lib.fused_mlp_forward_f32.argtypes = fn.argtypes
        lib.fused_mlp_forward_f32.restype = ctypes.c_int
        lib.fused_mlp_plan_f32.argtypes = lib.fused_mlp_plan.argtypes
        lib.fused_mlp_plan_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused_mlp_reference(x, weights, compute_dtype=torch.bfloat16):
    """The JAX package's `_xla_mlp` (fused_mlp.py:107-114), whose VJP is
    K4's backward: operands rounded to `compute_dtype`, f32 sums, ReLU
    between layers, the last layer kept in f32 (the kernel rounds it)."""
    h = x
    for i, w in enumerate(weights):
        h = dot(h, w, compute_dtype)
        if i != len(weights) - 1:
            h = torch.relu(h)
    return h


def fused_mlp_plain(x, weights, compute_dtype=torch.bfloat16):
    """The kernel's function in plain PyTorch: `fused_mlp_reference` with
    its last layer rounded to `compute_dtype` too (each layer's input is
    rounded by the next product already). x [N, D_0]; weights [in, out]
    each. Returns [N, D_L] f32."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return fused_mlp_reference(x, weights, compute_dtype).to(
        compute_dtype).float()


def fused_mlp_grouped_plain(x, weights, compute_dtype=torch.bfloat16):
    """The grouped kernel's function in plain PyTorch: the JAX package's
    `_xla_mlp` under vmap, as batched products (`fused_mlp_reference` on
    x [G, N, D_0] and weights [G, in, out]), every layer rounded to
    `compute_dtype`. Returns [G, N, D_L] f32."""
    global PLAIN_CALLS_GROUPED
    PLAIN_CALLS_GROUPED += 1
    return fused_mlp_reference(x, weights, compute_dtype).to(
        compute_dtype).float()


class _K4(torch.autograd.Function):
    """out = launch(x, weights); the backward recomputes
    fused_mlp_reference(x, weights) under autograd and takes its
    vector-Jacobian product with the cotangent."""

    @staticmethod
    def forward(ctx, launch, compute_dtype, x, *weights):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, *weights)
        return launch(x, weights)

    @staticmethod
    def backward(ctx, g_out):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [a.detach().requires_grad_(n)
                    for a, n in zip(ctx.saved_tensors, need)]
            out = fused_mlp_reference(args[0], args[1:], ctx.compute_dtype)
            wrt = [a for a, n in zip(args, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g_out,
                                             allow_unused=True))
        return (None, None) + tuple(next(grads) if n else None
                                    for n in need)


def _pad16(v):
    return (v + 15) // 16 * 16


def _plan(widths):
    """A block's shared memory for these widths (csrc/fused_mlp.cu
    plan_of): the ring's barriers, the weight image (every layer
    [pad16(D_l), pad16(D_l+1)] bf16), then as many stages of one tile of x
    as fit, at most MAX_STAGES; bytes of each part, the stage count (0 when
    not one stage fits) and the bytes in all (0 then)."""
    weights = 2 * sum(_pad16(a) * _pad16(b)
                      for a, b in zip(widths, widths[1:]))
    stage = TILE_ROWS * widths[0] * 2
    room = MAX_SMEM - BARRIER_BYTES - weights
    stages = 0 if room < stage else min(MAX_STAGES, room // stage)
    total = BARRIER_BYTES + weights + stages * stage if stages else 0
    return dict(barriers=BARRIER_BYTES, weights=weights, stage=stage,
                stages=stages, total=total)


def _p2(v):
    """A width in the f32 images: a power of two, >= 8."""
    return max(8, 1 << (v - 1).bit_length())


def _fixed_net(widths):
    """Whether the f32 kernel has a build for these exact layer shapes
    (csrc/fused_mlp.cu fixed_net): the hash-grid field's sigma net
    [<= 32, 33..64, 9..16] and color net [<= 32, 33..64, 33..64, <=
    FMA_OUT]."""
    p = [_p2(v) for v in widths]
    return p[:2] == [32, 64] and (
        (len(p) == 3 and p[2] == 16)
        or (len(p) == 4 and p[2] == 64 and widths[3] <= FMA_OUT))


def _f32_layers(widths):
    """Every layer of the f32 image (csrc/fused_mlp.cu layer_bytes):
    ("tf32", K_l, N_l), its hi and lo images; or, for a last layer at most
    FMA_OUT wide, ("fma", K_l, FMA_OUT), its f32 weights row-major. The
    widths: each rounded up to a power of two of at least 8 (wgmma's tf32
    k-step and N) for the nets with a build of their own (`_fixed_net`),
    to 64 or 128 for any other chain."""
    pad = _p2 if _fixed_net(widths) else (lambda v: 64 if v <= 64 else 128)
    last = len(widths) - 2
    return [("fma", pad(a), FMA_OUT) if l == last and b <= FMA_OUT
            else ("tf32", pad(a), pad(b))
            for l, (a, b) in enumerate(zip(widths, widths[1:]))]


def _layer_bytes(kind, k, n):
    return 4 * k * n * (2 if kind == "tf32" else 1)


def _f32_tile_rows(widths):
    """Rows of the f32 kernel's tile: 64 a consumer warpgroup, F32_CONSUMERS
    of them in the build for widths up to 64, one in the build for 128."""
    return 64 * (F32_CONSUMERS if max(widths) <= 64 else 1)


def _plan_f32(widths):
    """A block's shared memory in the f32 kernel (csrc/fused_mlp.cu
    plan_f32): the barriers, the weights (every layer where they fit beside
    one stage: resident; else room for the largest layer), then as many
    stages of a tile of x (f32) as fit, at most MAX_STAGES_F32, a power of
    two; bytes of each part, the stage count (0 when not one stage fits)
    and the bytes in all (0 then)."""
    sizes = [_layer_bytes(*layer) for layer in _f32_layers(widths)]
    stage = _f32_tile_rows(widths) * widths[0] * 4
    room = MAX_SMEM - BARRIER_BYTES
    resident = sum(sizes) + stage <= room
    weights = sum(sizes) if resident else max(sizes)
    left = room - weights
    stages = 0 if left < stage else min(MAX_STAGES_F32, left // stage)
    stages = 1 << (stages.bit_length() - 1) if stages else 0
    total = BARRIER_BYTES + weights + stages * stage if stages else 0
    return dict(barriers=BARRIER_BYTES, weights=weights, resident=resident,
                stage=stage, stages=stages, total=total)


def fused_mlp_tf32_emulated(x, weights, products=3):
    """The f32 kernel's arithmetic in plain PyTorch: each tensor-core
    layer's operands split into tf32 values (`tf32_split`) and summed in f32
    as lo @ W_hi + hi @ W_lo + hi @ W_hi (products=3), or as a single tf32
    product hi @ W_hi (products=1, what the kernel does not do); a last
    layer at most FMA_OUT wide in f32 (the kernel's FFMA); ReLU between
    layers, the last layer in f32. x [N, D_0]; weights [in, out] each."""
    h = x.float()
    for i, w in enumerate(weights):
        if i == len(weights) - 1 and w.shape[1] <= FMA_OUT:
            return h @ w.float()
        h = tf32_dot(h, w, products)
        if i != len(weights) - 1:
            h = torch.relu(h)
    return h


def launch_plan(widths, compute_dtype=torch.bfloat16):
    """The built kernel's own plan on this card for these widths. bf16:
    (rows a tile, stages, stage bytes, shared-memory bytes of a block,
    blocks per SM, k-steps of A a thread holds: 4 up to 64 columns, else
    8); f32: (rows a tile, 1 if the weights stay in shared memory, stages,
    shared-memory bytes of a block, blocks per SM, the build's widest
    padded width: 64, or 128)."""
    dims = (ctypes.c_int * len(widths))(*widths)
    plan = (ctypes.c_int * 6)()
    lib = _library()
    fn = lib.fused_mlp_plan_f32 if compute_dtype == torch.float32 \
        else lib.fused_mlp_plan
    err = fn(dims, len(widths) - 1, plan)
    if err != 0:
        raise RuntimeError(f"fused_mlp launch plan failed: cudaError {err}")
    return tuple(plan)


def _widths(weights, f32: bool = False):
    """[D_0, ..., D_L] of a chain of [in, out] weights; raises for a chain
    that does not link up or that the kernel (the bf16 one, or the f32
    one with `f32`) does not take."""
    widths = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    if any(w.ndim != 2 or w.shape[0] != widths[i]
           for i, w in enumerate(weights)):
        raise ValueError(f"weights {[tuple(w.shape) for w in weights]} do "
                         "not chain")
    fits = (_plan_f32 if f32 else _plan)(widths)["stages"] >= 1
    if not (1 <= len(weights) <= MAX_LAYERS
            and max(widths) <= MAX_WIDTH and fits):
        raise ValueError(f"K4 takes 1..{MAX_LAYERS} layers of widths up to "
                         f"{MAX_WIDTH} whose padded weights and one tile of "
                         f"rows fit a block's shared memory, got widths "
                         f"{widths}")
    return widths


def _prepare(weights):
    """(widths, packed weights): every layer zero-padded to [16k, 16m]
    bf16, as wgmma's B image, all of them in one contiguous buffer, built
    once per set of weights."""
    return _prepared.get(list(weights), lambda: _pack(weights))


def _prepare_f32(weights):
    """(widths, packed weights) of the f32 kernel (`_f32_layers`): every
    tensor-core layer zero-padded to [K_l, N_l], split into tf32 hi and lo,
    each as `wgmma_b_tf32`'s image, hi then lo; an FFMA last layer
    zero-padded to [K_l, FMA_OUT]; the layers one after another in one f32
    buffer, built once per set of weights."""
    return _prepared.get(list(weights), lambda: _pack_f32(weights),
                         tag="f32")


def _pack_f32(weights):
    widths = _widths(weights, f32=True)
    parts = []
    for w, (kind, k, n) in zip(weights, _f32_layers(widths)):
        p = torch.zeros((k, n), dtype=torch.float32, device=w.device)
        p[:w.shape[0], :w.shape[1]] = w
        if kind == "fma":
            parts.append(p.reshape(-1))
        else:
            parts.extend(tf32_chunks(p))
    return widths, torch.cat(parts).contiguous()


def _pack(weights):
    widths = _widths(weights)
    parts = []
    for w in weights:
        p = torch.zeros((_pad16(w.shape[0]), _pad16(w.shape[1])),
                        dtype=torch.bfloat16, device=w.device)
        p[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
        parts.append(wgmma_b(p))
    return widths, torch.cat(parts).contiguous()


def _grouped_widths(weights):
    """[D_0, ..., D_L] of grouped weights, each [G, in, out] with one G;
    raises for any other set, or one the kernel does not take."""
    G = weights[0].shape[0]
    if any(w.ndim != 3 or w.shape[0] != G for w in weights):
        raise ValueError(f"grouped weights {[tuple(w.shape) for w in weights]}"
                         " are not [G, in, out] with one G")
    return _widths([w[0] for w in weights])


def grouped_image_mirror(weights, g):
    """Group g's bf16 image as a block of the grouped kernel builds it
    (csrc/fused_mlp.cu pack_group), in Python: layer l's image element p
    of the 16-byte row q = p - p % 8 is weight [k, n] read at its storage
    offset + g stride[0] + k stride[1] + n stride[2], k = 16 (r // groups8)
    + 8 ((q >> 6) & 1) + p % 8, n = 8 (r % groups8) + (q >> 3) % 8, r = q
    >> 7, groups8 = pad16(D_l+1) / 8; zero past the weight's edges; rounded
    to bf16. Equals `_pack`'s image of the group's weights."""
    widths = _grouped_widths(weights)
    parts = []
    for w, d_in, d_out in zip(weights, widths, widths[1:]):
        flat = torch.empty(0, dtype=w.dtype, device=w.device).set_(
            w.untyped_storage())
        p = torch.arange(_pad16(d_in) * _pad16(d_out), device=w.device)
        q = p - p % 8
        groups8 = _pad16(d_out) // 8
        r = q >> 7
        k = (r // groups8) * 16 + ((q >> 6) & 1) * 8 + p % 8
        n = (r % groups8) * 8 + (q >> 3) % 8
        inside = (k < d_in) & (n < d_out)
        s0, s1, s2 = w.stride()
        at = w.storage_offset() + g * s0 + k * s1 + n * s2
        v = torch.where(inside, flat[torch.where(inside, at, 0)].float(),
                        0.0)
        parts.append(v.to(torch.bfloat16))
    return torch.cat(parts)


def fused_mlp_grouped(x, weights, compute_dtype=torch.bfloat16):
    """G bias-free ReLU MLPs: x [G, N, D_0], weights [G, in, out] each (one
    set per group); returns [G, N, D_L] f32, every layer rounded to
    `compute_dtype`; differentiable in x and the weights (the backward is
    `fused_mlp_reference`'s VJP on the batched products).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    grouped kernel (bf16 only; G <= MAX_GROUPS, N * D_0 a multiple of 8)
    or raises."""
    if x.device.type == "cpu":
        def launch(x_, ws):
            return fused_mlp_grouped_plain(x_, ws, compute_dtype)
    elif x.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {x.device}")
    else:
        if compute_dtype != torch.bfloat16:
            raise ValueError("the grouped K4 kernel computes in bfloat16")
        if any(w.device != x.device for w in weights):
            raise ValueError("x and the weights must be on one device")

        def launch(x_, ws):
            return _launch_grouped(x_, ws)
    return _K4.apply(launch, compute_dtype, x, *weights)


def _launch_grouped(x, weights):
    """One launch of the grouped kernel on CUDA tensors: each block packs
    its group's image from the f32 weights as they lie (other dtypes are
    cast first)."""
    global LAUNCHES_GROUPED
    widths = _grouped_widths(weights)
    G = weights[0].shape[0]
    if x.ndim != 3 or x.shape[0] != G or x.shape[2] != widths[0]:
        raise ValueError(f"x must be [{G}, N, {widths[0]}], got "
                         f"{tuple(x.shape)}")
    n = x.shape[1]
    if G > MAX_GROUPS or (n * widths[0]) % 8:
        raise ValueError(f"the grouped K4 takes at most {MAX_GROUPS} groups "
                         "whose rows hold a multiple of 8 values, got "
                         f"{tuple(x.shape)}")
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    ws = [w if w.dtype == torch.float32 else w.float() for w in weights]
    out = torch.empty((G, n, widths[-1]), dtype=torch.float32,
                      device=x.device)
    if n and G:
        ptrs = (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws])
        strides = (ctypes.c_int64 * (3 * len(ws)))(
            *[s for w in ws for s in w.stride()])
        dims = (ctypes.c_int * len(widths))(*widths)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _library().fused_mlp_forward_grouped(
                x.data_ptr(), ptrs, strides, dims, len(ws), out.data_ptr(),
                n, G, stream)
        if err != 0:
            raise RuntimeError(f"fused_mlp grouped launch failed: cudaError "
                               f"{err}")
        LAUNCHES_GROUPED += 1
    return out


def fused_mlp(x, weights, compute_dtype=torch.bfloat16):
    """Bias-free ReLU MLP over x [N, D_0] with weights [in, out] each;
    returns [N, D_L] f32, every layer rounded to `compute_dtype`;
    differentiable (the backward is `fused_mlp_reference`'s VJP).

    A CPU tensor takes the plain version. A CUDA tensor launches a kernel:
    the bf16 one, or with compute_dtype float32 the f32 one; either takes
    at most MAX_LAYERS layers of widths up to MAX_WIDTH. x is cast to the
    compute dtype and must then be contiguous (and, in bf16, start on a
    16-byte boundary; an f32 x that does not is copied first, for the
    kernel's bulk copies); anything else raises."""
    if x.device.type == "cpu":
        def launch(x_, ws):
            return fused_mlp_plain(x_, ws, compute_dtype)
    elif x.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {x.device}")
    else:
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("the CUDA kernels compute in bfloat16 or "
                             "float32")
        if any(w.device != x.device for w in weights):
            raise ValueError("x and the weights must be on one device")

        def launch(x_, ws):
            return _launch(x_, ws, compute_dtype)
    return _K4.apply(launch, compute_dtype, x, *weights)


def _launch(x, weights, compute_dtype):
    """One launch of the kernel of `compute_dtype` on CUDA tensors."""
    global LAUNCHES, LAUNCHES_F32
    f32 = compute_dtype == torch.float32
    widths, packed = (_prepare_f32 if f32 else _prepare)(list(weights))
    n = x.shape[0]
    if x.ndim != 2 or x.shape[1] != widths[0]:
        raise ValueError(f"x must be [N, {widths[0]}], got "
                         f"{tuple(x.shape)}")
    x = x.to(compute_dtype)
    if f32 and x.is_contiguous() and x.data_ptr() % 16:
        x = x.clone()
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and start on a 16-byte "
                         "boundary (in bfloat16)")
    out = torch.empty((n, widths[-1]), dtype=torch.float32, device=x.device)
    if n:
        dims = (ctypes.c_int * len(widths))(*widths)
        lib = _library()
        fn = lib.fused_mlp_forward_f32 if f32 else lib.fused_mlp_forward
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), packed.data_ptr(), dims, len(weights),
                     out.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"fused_mlp launch ({compute_dtype}) failed:"
                               f" cudaError {err}")
        if f32:
            LAUNCHES_F32 += 1
        else:
            LAUNCHES += 1
    return out
