"""Kernel K3: the mip-fold teacher's field chain from its encoding.

`fused_sigma_color` is the counterpart of the JAX package's Pallas kernel of
the same name (nerfsafetyvalidation_tpu/ops/pallas/render_mlp.py). On a
CUDA tensor it launches a hand-written kernel in `csrc/sigma_color.cu`, in
bfloat16 or float32, or raises; on a CPU tensor it runs the plain PyTorch
version `fused_sigma_color_plain` (the JAX package's `_xla_ref`, with the
same rounding points), which the tests compare with JAX.

It is differentiable, as the JAX function is: on the card through K1's
autograd Function (`points_mlp._Chain`), whose forward launches the kernel
and whose backward recomputes the plain chain (`_chain`) in the compute
dtype under autograd and returns its vector-Jacobian product for enc, sh
and the five weights (the JAX `_fused_bwd` is the VJP of `_xla_ref`,
recomputed through XLA; the TPU kernel has no backward kernel).

The kernels are built at first use with `nvcc` into `_build/` beside the
package and bound with ctypes. Their weights are one operand, `image`,
packed once per set of weights and dtype (and again after an in-place
update, which the weight cache's key sees): in bfloat16 the six matrices of
`_prep_mats` (the last one padded to 16 columns) as the shared-memory image
that `wgmma` reads as its B operand (`wgmma_image.wgmma_b`), which each
block of the kernel loads whole, the rows streaming through a ring of bulk
copies; in float32 the five layers row-major (`pack_image_f32`), which each
block of the FFMA kernel loads into shared memory once.
"""

import ctypes
from functools import partial
from pathlib import Path

import torch

from ._nvcc import WeightCache, compile_source
from .points_mlp import _Chain
from .wgmma_image import dot, wgmma_b

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "sigma_color.cu"

ENC, HID, GEO, SH, COLOR, LAST_COLS = 32, 64, 16, 16, 64, 8
# the kernel's launch (csrc/sigma_color.cu): consumer warpgroups of 64 rows
# a block, rows a tile, stages of the row ring, bytes of its barriers
CONSUMERS = 2
TILE_ROWS = 64 * CONSUMERS
STAGES = 6
BARRIER_BYTES = 128
# the weight image's matrices, in order, [in, out] as wgmma reads them:
# W1, W2, C1s, C1g, C2, C3 with its columns padded to IMAGE_LAST
IMAGE_LAST = 16
IMAGE_SHAPES = ((ENC, HID), (HID, GEO), (SH, COLOR), (GEO, COLOR),
                (COLOR, COLOR), (COLOR, IMAGE_LAST))
WEIGHT_BYTES = 2 * sum(k * n for k, n in IMAGE_SHAPES)
# the float32 kernel's image: W1, W2, C1 = [C1s; C1g], C2, C3 with its
# columns padded to IMAGE_LAST_F32, row-major [in, out], one after another
IMAGE_LAST_F32 = 4
IMAGE_SHAPES_F32 = ((ENC, HID), (HID, GEO), (SH + GEO, COLOR),
                    (COLOR, COLOR), (COLOR, IMAGE_LAST_F32))
WEIGHT_FLOATS_F32 = sum(k * n for k, n in IMAGE_SHAPES_F32)
# what each dtype's image holds (the weight cache's tag)
LAYOUT = {torch.bfloat16: "wgmma-B-kmajor-noswizzle",
          torch.float32: "rowmajor-f32"}

# launches of the CUDA kernels since the last reset (never the plain path):
# the bf16 kernel's and the float32 one's; and the calls of the plain
# version (the backward's recompute is not one)
LAUNCHES = 0
LAUNCHES_F32 = 0
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
        for name in ("sigma_color_forward", "sigma_color_forward_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.sigma_color_plan.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.sigma_color_plan.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused_sigma_color_plain(enc, sh, sigma_net, color_net,
                            compute_dtype=torch.bfloat16):
    """The kernel's function in plain PyTorch: operands rounded to
    `compute_dtype`, f32 sums. Returns (sigma [N] f32, rgb [N, 3] f32)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return _chain(compute_dtype, enc, sh, *sigma_net, *color_net)


def _chain(dt, enc, sh, w1, w2, c1, c2, c3):
    """`fused_sigma_color_plain`'s arithmetic, uncounted (the backward's
    recompute)."""
    h = torch.relu(dot(enc, w1, dt))
    s = dot(h, w2, dt)
    sigma = torch.exp(torch.clamp(s[..., 0], -15.0, 15.0))
    hin = torch.cat([sh.to(dt), s[..., 1:].to(dt)], dim=-1)
    g = torch.relu(dot(hin, c1, dt))
    g = torch.relu(dot(g, c2, dt))
    return sigma, torch.sigmoid(dot(g, c3, dt))


def _prep_mats(sigma_net, color_net, sh_dim, dtype):
    """The color net's first layer split into the (sh, geo) pair, with a
    zero row in front of the geo rows so the whole sigma-net output feeds
    it, and the last layer padded to 8 columns (render_mlp.py _prep_mats)."""
    w1, w2 = sigma_net
    c1, c2, c3 = color_net
    c1g = torch.zeros((w2.shape[1], c1.shape[1]), dtype=c1.dtype,
                      device=c1.device)
    c1g[1:1 + c1.shape[0] - sh_dim] = c1[sh_dim:]
    c3p = torch.zeros((c3.shape[0], LAST_COLS), dtype=c3.dtype,
                      device=c3.device)
    c3p[:, :3] = c3
    return tuple(m.to(dtype).contiguous()
                 for m in (w1, w2, c1[:sh_dim], c1g, c2, c3p))


def smem_plan():
    """A block's shared memory (csrc/sigma_color.cu): the ring's barriers,
    the weight image, then STAGES stages of one tile's enc rows and sh
    rows; bytes of each part, and in all."""
    stage = TILE_ROWS * (ENC + SH) * 2
    return dict(barriers=BARRIER_BYTES, weights=WEIGHT_BYTES, stage=stage,
                stages=STAGES,
                total=BARRIER_BYTES + WEIGHT_BYTES + STAGES * stage)


def launch_plan():
    """The built kernel's own plan on this card: (rows a tile, blocks per
    SM, shared-memory bytes of a block)."""
    plan = (ctypes.c_int * 3)()
    err = _library().sigma_color_plan(plan)
    if err != 0:
        raise RuntimeError(f"sigma_color_plan failed: cudaError {err}")
    return tuple(plan)


def pack_image(mats):
    """The six matrices of `_prep_mats`, C3 padded to IMAGE_LAST columns,
    each as wgmma's B image (`wgmma_image.wgmma_b`), one after another."""
    *head, c3 = mats
    c3p = torch.zeros((c3.shape[0], IMAGE_LAST), dtype=c3.dtype,
                      device=c3.device)
    c3p[:, :c3.shape[1]] = c3
    return torch.cat([wgmma_b(m) for m in (*head, c3p)]).contiguous()


def pack_image_f32(mats):
    """The float32 kernel's one weight operand from the six matrices of
    `_prep_mats`: W1, W2, C1 = [C1s; C1g], C2 and C3's first
    IMAGE_LAST_F32 columns, row-major, one after another."""
    w1, w2, c1s, c1g, c2, c3 = mats
    layers = (w1, w2, torch.cat([c1s, c1g]), c2, c3[:, :IMAGE_LAST_F32])
    return torch.cat([w.reshape(-1) for w in layers]).contiguous()


def _prepare(sigma_net, color_net, dtype=torch.bfloat16):
    """Kernel operands in `dtype`, built once per set of weights (and
    again after they change in place): `mats`, the six matrices of
    `_prep_mats` (the TPU kernel's layout), and `image`, those packed for
    the kernel (`pack_image` in bf16, `pack_image_f32` in float32)."""
    weights = list(sigma_net) + list(color_net)
    want = [(ENC, HID), (HID, GEO), (SH + GEO - 1, COLOR), (COLOR, COLOR),
            (COLOR, 3)]
    if [tuple(w.shape) for w in weights] != want:
        raise ValueError(f"K3 takes a sigma net {ENC} -> {HID} -> {GEO} and "
                         f"a color net {SH + GEO - 1} -> {COLOR} -> {COLOR} "
                         f"-> 3, got {[tuple(w.shape) for w in weights]}")
    def prep():
        with torch.no_grad():
            mats = _prep_mats(sigma_net, color_net, SH, dtype)
            pack = pack_image if dtype == torch.bfloat16 else pack_image_f32
            return dict(mats=mats, image=pack(mats))

    return _prepared.get(weights, prep, tag=f"{dtype}/{LAYOUT[dtype]}")


def fused_sigma_color(enc, sh, sigma_net, color_net,
                      compute_dtype=torch.bfloat16):
    """enc [N, 32] mip-fold encoding, sh [N, 16] encoded directions;
    sigma_net (W1, W2), color_net (C1, C2, C3), [in, out] weights with C1's
    rows ordered [sh | geo]. Returns (sigma [N] f32, rgb [N, 3] f32),
    differentiable.

    A CPU tensor takes the plain version, under autograd. A CUDA tensor
    launches the kernel of `compute_dtype` (bfloat16 or float32) through
    `_Chain`: enc and sh in the compute dtype, contiguous and 16-byte
    aligned; anything else raises."""
    if enc.device.type == "cpu":
        return fused_sigma_color_plain(enc, sh, sigma_net, color_net,
                                       compute_dtype)
    if enc.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {enc.device}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K3 computes in bfloat16 or float32, not "
                         f"{compute_dtype}")
    n = enc.shape[0]
    dt = compute_dtype
    if enc.dtype != dt or tuple(enc.shape) != (n, ENC):
        raise ValueError(f"enc must be {dt} [N, {ENC}], got {enc.dtype} "
                         f"{tuple(enc.shape)}")
    if sh.dtype != dt or tuple(sh.shape) != (n, SH):
        raise ValueError(f"sh must be {dt} [N, {SH}], got {sh.dtype} "
                         f"{tuple(sh.shape)}")
    if not (enc.is_contiguous() and sh.is_contiguous()):
        raise ValueError("enc and sh must be contiguous")
    if enc.data_ptr() % 16 or sh.data_ptr() % 16:
        raise ValueError("enc and sh must start on a 16-byte boundary")
    tensors = [enc, sh] + list(sigma_net) + list(color_net)
    if any(t.device != enc.device for t in tensors):
        raise ValueError("enc, sh and the weights must be on one device")
    f32 = dt == torch.float32
    name = "sigma_color_forward_f32" if f32 else "sigma_color_forward"

    def launch(enc, sh, *weights):
        global LAUNCHES, LAUNCHES_F32
        image = _prepare(weights[:2], weights[2:], dt)["image"]
        out = torch.empty((n, 4), dtype=torch.float32, device=enc.device)
        if n:
            with torch.cuda.device(enc.device):
                stream = torch.cuda.current_stream(enc.device).cuda_stream
                err = getattr(_library(), name)(
                    enc.data_ptr(), sh.data_ptr(), image.data_ptr(),
                    out.data_ptr(), n, stream)
            if err != 0:
                raise RuntimeError(f"{name} launch failed: cudaError {err}")
            if f32:
                LAUNCHES_F32 += 1
            else:
                LAUNCHES += 1
        return out

    out = _Chain.apply(launch, partial(_chain, dt), enc, sh, *sigma_net,
                       *color_net)
    return out[:, 0], out[:, 1:4]
