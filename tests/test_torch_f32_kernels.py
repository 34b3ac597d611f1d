"""The float32 variants of kernels K1 and K3 and K3's backward, on the CPU.

* K1's plain version in float32 against the JAX package's Pallas kernel
  `fused_points_sigma_color(..., compute_dtype=float32)` in interpret mode
  at multires 10, and the gap that the TPU kernel's shifted-sine cosine
  makes;
* K3's autograd Function (`points_mlp._Chain` over `sigma_color._chain`,
  launched by the plain forward on the CPU as on the card): its gradients for enc, sh and the five
  weights against `jax.grad` through the JAX `fused_sigma_color`, whose
  `custom_vjp` backward is the VJP of `_xla_ref`, in float32 and bfloat16;
* the float32 kernels' operands: K3's row-major image, the weight cache
  after an in-place update, and the dtypes a CUDA tensor may ask for.

The fused float32 nets are held to JAX's `apply` elsewhere: the mip-fold
teacher in tests/test_torch_sigma_color.py, the frequency student at full
width in tests/test_torch_network.py."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops.pallas import render_mlp as J
from nerfsafetyvalidation_tpu_torch.ops.hopper import points_mlp as pm
from nerfsafetyvalidation_tpu_torch.ops.hopper import sigma_color as sc

# one torch thread: MKL's threaded sin/cos is not exact under load
# (see test_torch_ops.py)
torch.set_num_threads(1)

W3 = [(32, 64), (64, 16), (31, 64), (64, 64), (64, 3)]


def _k1_nets(multires=10, hidden=32, rows=300, seed=4):
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return rng.normal(0, 0.15, (i, o)).astype(np.float32)

    sn = [mat(3 + 6 * multires, hidden), mat(hidden, hidden),
          mat(hidden, 16)]
    cn = [mat(31, 64), mat(64, 64), mat(64, 3)]
    x = rng.uniform(-1, 1, (rows, 3)).astype(np.float32)
    sh = rng.normal(0, 0.5, (rows, 16)).astype(np.float32)
    return x, sh, sn, cn


def test_k1_f32_plain_matches_jax_kernel_at_multires_10():
    """The TPU kernel computes cos(t) as sin(t + pi/2); at t = 2^9 x in
    float32 the shifted argument rounds by up to half an ulp of 512
    (3.05e-5), which moves that encoding column by as much. The port keeps
    cos(t) (XLA's `freq_encode`, and the CUDA kernel's cosf). Measured
    here: the encodings 1.08e-5 apart at most; the outputs 1.3e-6 relative
    on sigma and 3.9e-7 on rgb. Bounds: the shift at most half an ulp of
    2^9; the outputs JAX's own kernel-vs-XLA tolerance (rtol 5e-4, atol
    1e-5, test_fused_mlp.py)."""
    multires = 10
    x, sh, sn, cn = _k1_nets(multires)
    t = x[:, None, :] * (2.0 ** np.arange(multires, dtype=np.float32)
                         )[None, :, None]
    shifted = np.sin((t + np.float32(np.pi / 2)).astype(np.float32))
    gap = float(np.abs(np.cos(t) - shifted).max())
    assert gap <= 2.0 ** (9 - 24) * 1.01
    s_j, c_j = J.fused_points_sigma_color(
        jnp.asarray(x), jnp.asarray(sh), [jnp.asarray(w) for w in sn],
        [jnp.asarray(w) for w in cn], multires, compute_dtype=jnp.float32)
    before = pm.LAUNCHES_F32
    s_t, c_t = pm.fused_points_sigma_color(
        torch.from_numpy(x), torch.from_numpy(sh),
        [torch.from_numpy(w) for w in sn], [torch.from_numpy(w) for w in cn],
        multires, compute_dtype=torch.float32)
    assert pm.LAUNCHES_F32 == before          # the CPU runs the plain chain
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=5e-4,
                               atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=5e-4,
                               atol=1e-5)


def _k3_case(seed=6, rows=200):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 0.5, (rows, 32)).astype(np.float32)
    sh = rng.normal(0, 0.5, (rows, 16)).astype(np.float32)
    ws = [rng.normal(0, 0.2, s).astype(np.float32) for s in W3]
    g = rng.normal(size=(rows, 4)).astype(np.float32)
    return enc, sh, ws, g


def _plain_launch(dt):
    """A launch for `_Chain` that runs the plain forward ([N, 4] f32), as the
    kernel does on the card."""
    def launch(enc, sh, *w):
        s, c = sc.fused_sigma_color_plain(enc, sh, w[:2], w[2:], dt)
        return torch.cat([s[:, None], c], 1)
    return launch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_function_gradients_match_jax(dtype):
    """Loss sum(sigma * g0) + sum(rgb * g1..3) through the JAX
    `fused_sigma_color` (the Pallas forward in interpret mode, the VJP of
    `_xla_ref` backward) and through `_Chain`. Measured: float32 gradients
    2.2e-7 of each tensor's largest at most (the same sums in other
    orders); bfloat16 equal. Bounds: 1e-5 (float32) and 2^-6 (bfloat16,
    where a product rounded to bf16 may land on the neighbouring value
    under another sum order and the ReLU masks follow it) of each
    tensor's largest gradient."""
    enc, sh, ws, g = _k3_case()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(enc_, sh_, sn, cn):
        s, c = J.fused_sigma_color(enc_, sh_, sn, cn, compute_dtype=jdt)
        return jnp.sum(s * g[:, 0]) + jnp.sum(c * g[:, 1:])

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(enc), jnp.asarray(sh), [jnp.asarray(w) for w in ws[:2]],
        [jnp.asarray(w) for w in ws[2:]])
    want = [want[0], want[1], *want[2], *want[3]]
    leaves = [torch.tensor(a, requires_grad=True) for a in [enc, sh] + ws]
    out = pm._Chain.apply(_plain_launch(tdt), partial(sc._chain, tdt),
                          *leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=tol * np.abs(b).max())


def test_k3_f32_image_is_the_layers_row_major():
    """The float32 kernel's weight operand (csrc/sigma_color.cu
    kF32Off*): W1, W2, C1 = [C1s; C1g] with C1g's zero row 0, C2 and C3
    with a zero fourth column, row-major, one after another; 9,472 floats;
    a cache entry of its own beside the bf16 image."""
    _, _, ws, _ = _k3_case(rows=1)
    sn = [torch.from_numpy(w) for w in ws[:2]]
    cn = [torch.from_numpy(w) for w in ws[2:]]
    m = sc._prepare(sn, cn, torch.float32)
    image = m["image"]
    assert image.dtype == torch.float32 and image.dim() == 1
    assert image.numel() == sc.WEIGHT_FLOATS_F32 == 9472
    assert sc._prepare(sn, cn)["image"].dtype == torch.bfloat16
    c1 = torch.zeros((32, 64))
    c1[:16] = cn[0][:16]
    c1[17:] = cn[0][16:]
    c3 = torch.zeros((64, 4))
    c3[:, :3] = cn[2]
    off = 0
    for want, shape in zip((sn[0], sn[1], c1, cn[1], c3),
                           sc.IMAGE_SHAPES_F32):
        k, n = shape
        assert tuple(want.shape) == shape
        assert torch.equal(image[off:off + k * n].reshape(k, n), want)
        off += k * n
    assert off == image.numel()


def test_weight_cache_follows_in_place_updates():
    """An optimizer updates the weights in place every step: the packed
    image is rebuilt from the new values (the key holds each tensor's
    version), and over many steps the cache stays at its size."""
    _, _, ws, _ = _k3_case(rows=1)
    params = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws]
    opt = torch.optim.Adam(params, lr=1e-2)
    for dt in (torch.float32, torch.bfloat16):
        old = sc._prepare(params[:2], params[2:], dt)["image"].clone()
        assert torch.equal(sc._prepare(params[:2], params[2:], dt)["image"],
                           old)
        for p in params:
            p.grad = torch.ones_like(p)
        opt.step()
        new = sc._prepare(params[:2], params[2:], dt)["image"]
        want = sc._prepare([p.detach().clone() for p in params[:2]],
                           [p.detach().clone() for p in params[2:]],
                           dt)["image"]
        assert not torch.equal(new, old) and torch.equal(new, want)
    for _ in range(3 * sc._prepared.size):
        for p in params:
            p.grad = torch.ones_like(p)
        opt.step()
        sc._prepare(params[:2], params[2:], torch.float32)
        assert len(sc._prepared._entries) <= sc._prepared.size


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_non_cpu_float32_reaches_the_kernel_or_raises(kernel):
    """Float32 and bfloat16 are the kernels' dtypes: for a tensor off the
    CPU each goes on to the device check (ValueError for the meta device,
    which has no kernel), with or without weights that require grad; any
    other compute dtype raises too."""
    def meta(shape, grad=False):
        return torch.empty(shape, device="meta", requires_grad=grad)

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for grad in (True, False):
            if kernel == "K3":
                ws = [meta(s, grad) for s in W3]
                with pytest.raises(ValueError):
                    sc.fused_sigma_color(meta((8, 32)), meta((8, 16)),
                                         ws[:2], ws[2:], dt)
            else:
                _, _, sn, cn = _k1_nets(rows=1)
                ws = [meta(w.shape, grad) for w in sn + cn]
                with pytest.raises(ValueError):
                    pm.fused_points_sigma_color(meta((8, 3)), meta((8, 16)),
                                                ws[:3], ws[3:], 10, dt)
