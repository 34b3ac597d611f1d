"""The float32 kernel of K1 and K2 as a 3xTF32 `wgmma` kernel, on the CPU.

* Its arithmetic, emulated in plain PyTorch (every operand split into tf32
  hi and lo, lo W_hi + hi W_lo + hi W_hi summed in f32, the last layer as
  f32 FFMA: `points_mlp.fused_sigma_color_deep_tf32_emulated`), against
  the JAX package's own f32 kernels in interpret mode on the same seeded
  inputs and weights, at the tolerance the JAX package holds its f32
  kernels to (tests/test_fused_mlp.py: rtol 5e-4, atol 1e-5); on a
  committed student that tolerance holds and a dropped tf32 product
  misses it;
* the weight image read back as the producer streams it, chunk by chunk,
  through the descriptor's address function, its rows put back from
  K_ORDER: hi + lo gives back every weight, both tf32 values, C1g's row 0
  and all padding zero;
* the shared-memory plans, the Python mirror of the source's ring, the
  3xTF32 layer code shared with K4 f32, and the refusals."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops.pallas import render_mlp as J
from nerfsafetyvalidation_tpu_torch import flagship as F
from nerfsafetyvalidation_tpu_torch.ops.freq_encoding import freq_encode
from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as K
from nerfsafetyvalidation_tpu_torch.ops.hopper import points_mlp as pm
from nerfsafetyvalidation_tpu_torch.ops.sh_encoding import sh_encode

# one torch thread: MKL's threaded sin/cos is not exact under load
# (see test_torch_ops.py)
torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=1e-5)


def _mat(rng, i, o):
    """Weights at the scale of a trained net's: N(0, 1 / fan_in)."""
    return (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)


def _student(hidden, multires=12, n_hidden=1, n_color_mid=1, rows=256,
             seed=3):
    rng = np.random.default_rng(seed)
    sn = [_mat(rng, 3 + 6 * multires, hidden)] + [
        _mat(rng, hidden, hidden) for _ in range(n_hidden)] + [
        _mat(rng, hidden, 16)]
    cn = [_mat(rng, 31, 64)] + [_mat(rng, 64, 64)
                               for _ in range(n_color_mid)] + [
        _mat(rng, 64, 3)]
    x = rng.uniform(-1, 1, (rows, 3)).astype(np.float32)
    d = rng.normal(size=(rows, 16)).astype(np.float32)
    sh = d / np.linalg.norm(d, axis=1, keepdims=True)
    return x, sh, sn, cn


def _j(ws):
    return [jnp.asarray(w) for w in ws]


def _t(ws):
    return [torch.from_numpy(w) for w in ws]


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# --------------------------------------------- the arithmetic against JAX
@pytest.mark.parametrize("hidden", pm.HIDDEN_WIDTHS)
@pytest.mark.parametrize("multires", [12, 10])
def test_k1_tf32_matches_jax_kernel(multires, hidden):
    """K1 f32's arithmetic on the frequency encoding (cos(t), as the CUDA
    kernel takes it) against `fused_points_sigma_color(...,
    compute_dtype=float32)`'s Pallas kernel in interpret mode, which takes
    sin(t + pi/2) (tests/test_torch_f32_kernels.py: up to half an ulp of
    2^(multires - 1) apart)."""
    x, sh, sn, cn = _student(hidden, multires)
    want = J.fused_points_sigma_color(jnp.asarray(x), jnp.asarray(sh),
                                      _j(sn), _j(cn), multires,
                                      compute_dtype=jnp.float32)
    got = pm.fused_sigma_color_deep_tf32_emulated(
        freq_encode(torch.from_numpy(x), multires), torch.from_numpy(sh),
        _t(sn), _t(cn))
    _close(got, want)


@pytest.mark.parametrize("hidden", pm.HIDDEN_WIDTHS)
def test_k2_tf32_matches_jax_kernel(hidden):
    """K2 f32 (K1's kernel reading the encoding) against
    `fused_sigma_color_deep(..., compute_dtype=float32)`'s Pallas kernel in
    interpret mode, on a given encoding of 75 columns, two hidden layers
    and two middle color layers."""
    x, sh, sn, cn = _student(hidden, n_hidden=2, n_color_mid=2, seed=8)
    enc = freq_encode(torch.from_numpy(x), 12).numpy()
    want = J.fused_sigma_color_deep(jnp.asarray(enc), jnp.asarray(sh),
                                    _j(sn), _j(cn), compute_dtype=jnp.float32)
    got = pm.fused_sigma_color_deep_tf32_emulated(
        torch.from_numpy(enc), torch.from_numpy(sh), _t(sn), _t(cn))
    _close(got, want)


@pytest.mark.parametrize("hidden", pm.HIDDEN_WIDTHS)
def test_tolerance_sees_a_dropped_tf32_product(hidden):
    """On a committed student's weights, at points on a held-out pose's
    rays inside the box, the 3xTF32 arithmetic stays within the JAX f32
    tolerance of the f32 chain, and the same with lo @ W_hi left out in
    every layer (2xTF32, the fault of a dropped product) misses it by more
    than 4x: the tolerance the card holds K1 f32 to tells the two apart."""
    net = F.load_student_net("cpu", "spheres", hidden, "float32")
    o, d = F.pose_rays(F.holdout_poses()[0], "cpu", res=32)
    t = torch.rand(o.shape[0], generator=torch.Generator().manual_seed(0))
    x = torch.clamp(o + (1.4 + 2.0 * t)[:, None] * d, -1.0, 1.0)
    enc, sh = freq_encode(x, 12), sh_encode(d)
    sn = [w.detach() for w in net.sigma_net]
    cn = [w.detach() for w in net.color_net]
    with torch.no_grad():
        want = pm.fused_sigma_color_deep_plain(enc, sh, sn, cn, torch.float32)
        got = pm.fused_sigma_color_deep_tf32_emulated(enc, sh, sn, cn)
        ctl = pm.fused_sigma_color_deep_tf32_emulated(enc, sh, sn, cn,
                                                      products=2)
    _close(got, want)

    def excess(a, b):   # the largest |a - b| over what TOL allows
        return float(((a - b).abs() / (TOL["atol"] + TOL["rtol"] * b.abs()))
                     .max())
    assert max(excess(ctl[0], want[0]), excess(ctl[1], want[1])) > 4


# ------------------------------------------------------- the weight images
def _b_address_tf32(k, n, cols):
    """Flat element of weight [k, n] in an 8-deep-k-step tf32 B image of
    `cols` columns (csrc/sm90.cuh b_desc with 4-byte elements): k-steps one
    after another, 8-column groups 256 bytes apart, the two 4-deep halves
    128 bytes apart, 8 x 4 core matrices of 16-byte rows."""
    return ((k // 8) * 8 * cols + (n // 8) * 64 + ((k % 8) // 4) * 32
            + (n % 8) * 4 + k % 4)


def _read_block(image, off, rows, cols):
    """One [rows, cols] tf32 B image at float `off`, read through the
    descriptor's address function, each k-step's rows put back from
    K_ORDER into the weights' order."""
    k, n = torch.meshgrid(torch.arange(rows), torch.arange(cols),
                          indexing="ij")
    img = image[off + _b_address_tf32(k, n, cols)]
    back = torch.empty_like(img)
    back[k[:, 0] // 8 * 8 + torch.tensor(K.K_ORDER)[k[:, 0] % 8]] = img
    return back


def _read_chunked(image, off, rows, cols, kch, parts):
    """A layer [rows, cols] streamed in `parts` column parts, each in chunks
    of kch k-steps, each chunk its hi image then its lo image: (hi, lo,
    offset after it)."""
    hi = torch.empty((rows, cols))
    lo = torch.empty((rows, cols))
    width = cols // parts
    for p in range(parts):
        cs = slice(p * width, (p + 1) * width)
        for r in range(0, rows, 8 * kch):
            for half in (hi, lo):
                half[r:r + 8 * kch, cs] = _read_block(image, off, 8 * kch,
                                                      width)
                off += 8 * kch * width
    return hi, lo, off


def _check_split(hi, lo, w):
    """hi and lo tf32 values whose sum gives w within 2^-21, relative, and
    zero wherever w is."""
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
        assert not half[w == 0].any()
    nz = w != 0
    rel = ((hi + lo)[nz] - w[nz]).abs() / w[nz].abs()
    assert float(rel.max()) <= 2.0 ** -21


@pytest.mark.parametrize("hidden", pm.HIDDEN_WIDTHS)
def test_k1_tf32_image_gives_back_every_weight(hidden):
    """K1 f32's image read in the order the producer streams it
    (csrc/points_mlp.cu): W1 [80, H] in 5 chunks of 2 k-steps, each hidden
    layer in RingF32's column parts (two of 128 at H = 256) of 2 k-steps a
    chunk a part, W_L whole, C1 = [C1s; 0; C1g] and each middle color layer
    in chunks of 4 k-steps, C_last [64, 4] f32: hi + lo gives every weight,
    zero in W1's rows past the encoding and in C1's row 16."""
    x, sh, sn, cn = _student(hidden, n_hidden=2, n_color_mid=2, seed=6)
    image = pm._prepare(_t(sn), _t(cn), torch.float32)["image"]
    parts = {160: 1, 192: 1, 256: 2}[hidden]
    w1 = torch.zeros((80, hidden))
    w1[:75] = torch.from_numpy(sn[0])
    c1 = torch.cat([torch.from_numpy(cn[0][:16]), torch.zeros((1, 64)),
                    torch.from_numpy(cn[0][16:])])
    stream = [(w1, 2, 1)] + [(torch.from_numpy(w), 2 * parts, parts)
                             for w in sn[1:-1]] + [
        (torch.from_numpy(sn[-1]), hidden // 8, 1), (c1, 4, 1)] + [
        (torch.from_numpy(w), 4, 1) for w in cn[1:-1]]
    off = 0
    for w, kch, p in stream:
        hi, lo, off = _read_chunked(image, off, *w.shape, kch, p)
        _check_split(hi, lo, w)
    last = image[off:].reshape(64, 4)
    assert torch.equal(last[:, :3], torch.from_numpy(cn[-1]))
    assert not last[:, 3].any()
    assert 4 * image.numel() == pm.f32_stream_bytes(hidden, 2, 2)


# ------------------------------------------------ plans and the sources
def _source_ints(path, pattern):
    return [int(v) for v in re.search(pattern, path.read_text()).groups()]


@pytest.mark.parametrize("hidden", pm.HIDDEN_WIDTHS)
def test_k1_f32_plan_fits_a_block(hidden):
    """RING_F32 mirrors csrc/points_mlp.cu's RingF32<H>; a stage holds one
    chunk of an H-wide layer (128 H bytes), and every color chunk; the
    barriers, the two warpgroups' scratch (the f32 encoding tile, or the
    parked half of a split layer, then the positions) and the ring fit the
    232,448 bytes a block may use (the source's f32_smem<H>, reckoned here
    from the layout its comments state)."""
    parts, stage, stages = pm.RING_F32[hidden]
    assert _source_ints(
        pm.SOURCE, rf"struct RingF32<{hidden}> {{\s*static constexpr int "
        r"kParts = (\d+), kStage = (\d+), kStages = (\d+);") == [
        parts, stage, stages]
    # a warpgroup's f32 encoding tile (64 rows of 80 + 8 floats), or at
    # H = 256 the parked first part of a hidden layer (64 x 128 f32) over
    # it, then its positions (64 x 3 f32)
    enc_tile, park = 64 * (pm.ENC_COLS + 8) * 4, 64 * 128 * 4
    scratch = (max(enc_tile, park) if parts > 1 else enc_tile) + 64 * 3 * 4
    ring = pm.RING_BARRIER_BYTES + 2 * scratch
    assert stage == 128 * hidden and 4 * 2 * 8 * 64 * 4 <= stage
    assert ring % 128 == 0 and 2 * stages * 8 <= pm.RING_BARRIER_BYTES
    assert ring + stages * stage <= K.MAX_SMEM
    assert (hidden // 8) % (2 * parts) == 0
    # setmaxnreg: the consumers' registers come from the producer's (the
    # launch gives each of the 384 threads 168); the input (H / 2 floats a
    # thread), an accumulator part (H / 2 / parts) and a group's split
    # temporaries (16) within the consumers' share
    prod, cons = (_source_ints(pm.SOURCE, rf"constexpr int {name} = (\d+);")[0]
                  for name in ("kF32ProducerRegs", "kF32ConsumerRegs"))
    assert 128 * (168 - prod) >= 256 * (cons - 168) and prod >= 24
    assert hidden // 2 + hidden // parts // 2 + 16 <= cons - 32


def test_f32_kernels_share_the_tf32_layers():
    """The 3xTF32 layer code lives once (csrc/sm90.cuh: tf32_group, the
    split and the three products) and K1's and K4's f32 kernels call it;
    neither source keeps a split of its own, and K1's FFMA kernel is gone."""
    csrc = pm.SOURCE.parent
    assert "void tf32_group(" in (csrc / "sm90.cuh").read_text()
    for name in ("points_mlp.cu", "fused_mlp.cu"):
        text = (csrc / name).read_text()
        assert '#include "sm90.cuh"' in text and "tf32_rna(" not in text
        assert "tf32_group<" in text or "tf32_products<" in text
        for gone in ("deep_mlp_f32_kernel", "F32Stream", "cp.async.cg"):
            assert gone not in text


def test_tf32_wrappers_refuse_other_shapes():
    """The f32 image is built for the kernel's shapes only: K1 and K2 refuse
    a hidden width without a build, a W_L of another width and a color net
    of other widths."""
    _, _, sn, cn = _student(160)
    rng = np.random.default_rng(0)
    bad = [_mat(rng, 75, 128), _mat(rng, 128, 16)]
    with pytest.raises(ValueError):
        pm._prepare(_t(bad), _t(cn), torch.float32)
    with pytest.raises(ValueError):
        pm._prepare(_t(sn[:-1] + [_mat(rng, 160, 8)]), _t(cn), torch.float32)
    with pytest.raises(ValueError):
        pm._prepare(_t(sn), _t([_mat(rng, 31, 32)] + cn[1:]), torch.float32)
