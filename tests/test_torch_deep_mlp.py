"""Kernel K2 of the port (ops/hopper/points_mlp.py `fused_sigma_color_deep`,
the encoding-in mode of K1's kernel) and the gradients of K1 and K2, on the
CPU: K2's plain version against the JAX package's Pallas kernel
`fused_sigma_color_deep` (interpret mode on the CPU) and `_xla_ref_deep`;
both plain versions' gradients against `jax.vjp` of the JAX functions; the
autograd Function the card's path goes through; and the autograd
Functions of K3 and K4, whose backwards are the VJPs of the JAX `_xla_ref`
and `_xla_mlp`."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops.pallas import render_mlp as J
from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as k4
from nerfsafetyvalidation_tpu_torch.ops.hopper import points_mlp as pm
from nerfsafetyvalidation_tpu_torch.ops.hopper import sigma_color as k3

torch.set_num_threads(1)


def _nets(hidden=256, n_sig=6, rows=300, seed=0):
    """sigma net 75 -> hidden x (n_sig - 1) -> 16, color net 31 -> 64 ->
    64 -> 3 (the JAX test's shapes, tests/test_fused_mlp.py), enc, sh and
    positions x; numpy float32."""
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return rng.normal(0, 0.15, (i, o)).astype(np.float32)

    sn = [mat(75, hidden)] + [mat(hidden, hidden)
                              for _ in range(n_sig - 2)] + [mat(hidden, 16)]
    cn = [mat(31, 64), mat(64, 64), mat(64, 3)]
    enc = rng.normal(0, 0.5, (rows, 75)).astype(np.float32)
    sh = rng.normal(0, 0.5, (rows, 16)).astype(np.float32)
    x = rng.uniform(-1, 1, (rows, 3)).astype(np.float32)
    return enc, sh, sn, cn, x


def _j(ws):
    return [jnp.asarray(w) for w in ws]


def _t(ws):
    return [torch.from_numpy(w) for w in ws]


def test_plain_matches_jax_kernel_and_reference_f32():
    """JAX's own tolerance between its kernel and `_xla_ref_deep`
    (tests/test_fused_mlp.py): rtol 1e-5, atol 1e-6. Measured: sigma
    7.1e-6 relative (sigma reaches exp(15)), rgb 1.0e-6."""
    enc, sh, sn, cn, _ = _nets()
    s_t, c_t = pm.fused_sigma_color_deep_plain(
        torch.from_numpy(enc), torch.from_numpy(sh), _t(sn), _t(cn),
        torch.float32)
    for s_j, c_j in (
            J.fused_sigma_color_deep(jnp.asarray(enc), jnp.asarray(sh),
                                     _j(sn), _j(cn),
                                     compute_dtype=jnp.float32),
            J._xla_ref_deep(jnp.asarray(enc), jnp.asarray(sh),
                            tuple(_j(sn)), tuple(_j(cn)), jnp.float32)):
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_matches_jax_kernel_bf16_student_width(seed):
    """bf16 at the student's width (160 x 6). Against the kernel and
    against `_xla_ref_deep` the port differs alike: where the f32 sums of
    the two frameworks land an activation on the neighbouring bf16 value
    (2^-8 relative), it runs on through the later layers. Measured over
    these two seeds: sigma 5.5e-3 relative, rgb 1.3e-3; bounded at about
    4x."""
    enc, sh, sn, cn, _ = _nets(hidden=160, seed=seed)
    s_t, c_t = pm.fused_sigma_color_deep_plain(
        torch.from_numpy(enc), torch.from_numpy(sh), _t(sn), _t(cn))
    s_j, c_j = J.fused_sigma_color_deep(jnp.asarray(enc), jnp.asarray(sh),
                                        _j(sn), _j(cn),
                                        compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2e-2,
                               atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=5e-3)


def _vjp_gap(kernel, jdt, tdt, hidden):
    """max |torch grad - jax grad| / max |jax grad| per input (first, sh,
    every weight) of K1 ("points") or K2 ("deep") for a fixed cotangent."""
    enc, sh, sn, cn, x = _nets(hidden=hidden, seed=3)
    first = x if kernel == "points" else enc
    rng = np.random.default_rng(9)
    g_s = rng.normal(size=first.shape[0]).astype(np.float32)
    g_c = rng.normal(size=(first.shape[0], 3)).astype(np.float32)
    if kernel == "points":
        def fj(a, s, w1, w2):
            return J.fused_points_sigma_color(a, s, w1, w2, 12,
                                              compute_dtype=jdt)

        def ft(a, s, w1, w2):
            return pm.fused_points_sigma_color(a, s, w1, w2, 12, tdt)
    else:
        def fj(a, s, w1, w2):
            return J.fused_sigma_color_deep(a, s, w1, w2, compute_dtype=jdt)

        def ft(a, s, w1, w2):
            return pm.fused_sigma_color_deep(a, s, w1, w2, tdt)
    _, vjp = jax.vjp(fj, jnp.asarray(first), jnp.asarray(sh), _j(sn),
                     _j(cn))
    d_first, d_sh, d_sn, d_cn = vjp((jnp.asarray(g_s), jnp.asarray(g_c)))
    want = [d_first, d_sh] + list(d_sn) + list(d_cn)
    leaves = [torch.tensor(a, requires_grad=True)
              for a in [first, sh] + sn + cn]
    s_t, c_t = ft(leaves[0], leaves[1], leaves[2:2 + len(sn)],
                  leaves[2 + len(sn):])
    got = torch.autograd.grad((s_t * torch.from_numpy(g_s)).sum()
                              + (c_t * torch.from_numpy(g_c)).sum(), leaves)
    return [float(np.abs(a.numpy() - np.asarray(b)).max()
                  / np.abs(np.asarray(b)).max()) for a, b in zip(got, want)]


@pytest.mark.parametrize("kernel", ["points", "deep"])
def test_plain_gradients_match_jax_vjp_f32(kernel):
    """The JAX kernels' custom_vjp recomputes through `_xla_ref_deep`; the
    port's plain chain under autograd is that chain. f32 at 256 x 6:
    measured 2.7e-6 of the largest gradient at most (sum order); bounded
    at 2e-5."""
    assert max(_vjp_gap(kernel, jnp.float32, torch.float32, 256)) <= 2e-5


@pytest.mark.parametrize("kernel", ["points", "deep"])
def test_plain_gradients_match_jax_vjp_bf16(kernel):
    """bf16 at the student's width (160 x 6): the forward's bf16 rounding
    flips (see the bf16 value test) move the cotangents too. Measured
    1.5e-3 of the largest gradient at most; bounded at 1e-2."""
    assert max(_vjp_gap(kernel, jnp.bfloat16, torch.bfloat16, 160)) <= 1e-2


def test_chain_function_backward_is_the_plain_vjp():
    """The card's route: `_Chain` launches in its forward and recomputes
    the plain chain in its backward. With a launch that computes the plain
    forward on the CPU, its gradients must equal autograd's through the
    plain chain bit for bit, for every input that requires grad."""
    enc, sh, sn, cn, _ = _nets(hidden=160, rows=64, seed=4)
    n_sig = len(sn)

    def plain(*args):
        return pm.fused_sigma_color_deep_plain(*pm._split(args, n_sig))

    def launch(*args):
        s, c = plain(*args)
        return torch.cat([s[:, None], c], dim=1)

    def grads(route):
        leaves = [torch.tensor(enc, requires_grad=True),
                  torch.from_numpy(sh)] + [torch.tensor(w, requires_grad=True)
                                           for w in sn + cn]
        if route == "chain":
            out = pm._Chain.apply(launch, plain, *leaves)
            s, c = out[:, 0], out[:, 1:4]
        else:
            s, c = plain(*leaves)
        loss = (s * torch.arange(64.0)).sum() + (c ** 2).sum()
        wrt = [a for a in leaves if a.requires_grad]
        return torch.autograd.grad(loss, wrt)

    for a, b in zip(grads("chain"), grads("plain")):
        assert torch.equal(a, b)


def test_cpu_wrapper_is_the_plain_version():
    enc, sh, sn, cn, _ = _nets(hidden=160, rows=64)
    before = pm.LAUNCHES_DEEP
    for dt in (torch.bfloat16, torch.float32):
        got = pm.fused_sigma_color_deep(torch.from_numpy(enc),
                                        torch.from_numpy(sh), _t(sn), _t(cn),
                                        dt)
        want = pm.fused_sigma_color_deep_plain(
            torch.from_numpy(enc), torch.from_numpy(sh), _t(sn), _t(cn), dt)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert pm.LAUNCHES_DEEP == before        # the plain path is never counted


def test_k1_plain_is_the_deep_chain_on_the_encoding():
    from nerfsafetyvalidation_tpu_torch.ops.freq_encoding import freq_encode
    _, sh, sn, cn, x = _nets(hidden=160, rows=64)
    x_t, sh_t = torch.from_numpy(x), torch.from_numpy(sh)
    for a, b in zip(pm.fused_points_sigma_color_plain(x_t, sh_t, _t(sn),
                                                      _t(cn), 12),
                    pm.fused_sigma_color_deep_plain(freq_encode(x_t, 12),
                                                    sh_t, _t(sn), _t(cn))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prepared_operands_per_dtype(dtype):
    """K2 in f32 packs the weights as K1 does, in f32; the weight cache
    keeps the two packings of one set of weights apart."""
    _, _, sn, cn, _ = _nets(hidden=192, n_sig=4, rows=1)
    sn_t, cn_t = _t(sn), _t(cn)
    m = pm._prepare(sn_t, cn_t, dtype)
    other = pm._prepare(sn_t, cn_t, torch.float32 if dtype == torch.bfloat16
                        else torch.bfloat16)
    assert m["w1"].dtype == dtype and other["w1"].dtype != dtype
    assert (m["hidden"], m["n_hidden"], m["n_color_mid"]) == (192, 2, 1)
    torch.testing.assert_close(m["w1"][:75], sn_t[0].to(dtype), rtol=0,
                               atol=0)
    assert not m["w1"][75:].any() and not m["c1g"][0].any()
    torch.testing.assert_close(m["c1g"][1:], cn_t[0][16:].to(dtype), rtol=0,
                               atol=0)
    torch.testing.assert_close(m["clast"][:, :3], cn_t[2].to(dtype), rtol=0,
                               atol=0)
    assert pm._prepare(sn_t, cn_t, dtype) is m


def test_non_cpu_tensor_never_takes_the_plain_path():
    """The meta device has no kernel: K2 raises for it, and for a compute
    dtype it has no kernel for."""
    _, _, sn, cn, _ = _nets(hidden=160, rows=1)
    meta = [torch.empty(w.shape, device="meta") for w in sn + cn]
    enc = torch.empty((8, 75), device="meta")
    sh = torch.empty((8, 16), device="meta")
    for dt in (torch.bfloat16, torch.float32, torch.float16):
        with pytest.raises(ValueError):
            pm.fused_sigma_color_deep(enc, sh, meta[:6], meta[6:], dt)


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_k3_k4_refuse_a_gradient_off_the_cpu(kernel):
    """K3 and K4 take a gradient: with weights that require grad, without,
    and under no_grad, each goes on to the device check (ValueError for
    the meta device); and each autograd Function, launched by the plain
    forward on the CPU as on the card, returns the VJP of its plain chain
    (the JAX `_xla_ref` and `_xla_mlp`) bit for bit, in float32 and
    bfloat16, for every input and weight. (The name predates their
    backward.)"""
    def meta(shape, grad=False):
        return torch.empty(shape, device="meta", requires_grad=grad)

    if kernel == "K4":
        for grad in (True, False):
            with pytest.raises(ValueError):
                k4.fused_mlp(meta((8, 32)), [meta((32, 64), grad),
                                             meta((64, 16), grad)])
        rng = np.random.default_rng(8)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.tensor(rng.normal(size=(40, 31)).astype(np.float32))
            ws = [torch.tensor(rng.normal(0, 0.2, s).astype(np.float32))
                  for s in ((31, 64), (64, 64), (64, 3))]
            g = torch.tensor(rng.normal(size=(40, 3)).astype(np.float32))
            leaves = [t.clone().requires_grad_() for t in [x] + ws]
            got = torch.autograd.grad(
                k4.fused_mlp(leaves[0], leaves[1:], dt), leaves, g)
            leaves = [t.clone().requires_grad_() for t in [x] + ws]
            want = torch.autograd.grad(
                k4.fused_mlp_reference(leaves[0], leaves[1:], dt), leaves,
                g)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    w3 = [(32, 64), (64, 16), (31, 64), (64, 64), (64, 3)]
    for grad in (True, False):
        ws = [meta(s, grad) for s in w3]
        with pytest.raises(ValueError):
            k3.fused_sigma_color(meta((8, 32)), meta((8, 16)), ws[:2],
                                 ws[2:])
    ws = [meta(s, True) for s in w3]
    with torch.no_grad(), pytest.raises(ValueError):
        k3.fused_sigma_color(meta((8, 32)), meta((8, 16)), ws[:2], ws[2:])
    rng = np.random.default_rng(9)
    for dt in (torch.float32, torch.bfloat16):
        ins = [torch.tensor(rng.normal(0, 0.5, s).astype(np.float32))
               for s in ((40, 32), (40, 16))]
        ws = [torch.tensor(rng.normal(0, 0.2, s).astype(np.float32))
              for s in w3]
        g = torch.tensor(rng.normal(size=(40, 4)).astype(np.float32))

        def launch(enc, sh, *w, dt=dt):
            s_, c_ = k3.fused_sigma_color_plain(enc, sh, w[:2], w[2:], dt)
            return torch.cat([s_[:, None], c_], 1)

        leaves = [t.clone().requires_grad_() for t in ins + ws]
        got = torch.autograd.grad(
            pm._Chain.apply(launch, partial(k3._chain, dt), *leaves), leaves,
            g)
        leaves = [t.clone().requires_grad_() for t in ins + ws]
        s_, c_ = k3.fused_sigma_color_plain(leaves[0], leaves[1],
                                            leaves[2:4], leaves[4:], dt)
        want = torch.autograd.grad((s_, c_), leaves, (g[:, 0], g[:, 1:]))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, _, sn, cn, _ = _nets(hidden=160, rows=1)
    ws = [meta(w.shape, True) for w in sn + cn]
    with pytest.raises(ValueError):
        pm.fused_points_sigma_color(meta((8, 3)), meta((8, 16)), ws[:6],
                                    ws[6:], 12)
    with pytest.raises(ValueError):
        pm.fused_sigma_color_deep(meta((8, 75)), meta((8, 16)), ws[:6],
                                  ws[6:])


@pytest.mark.parametrize("hidden", pm.HIDDEN_WIDTHS)
def test_f32_image_is_the_layers_row_major_in_order(hidden):
    """K1's and K2's f32 kernel streams its weights in chunks from one
    image (the name predates the 3xTF32 kernel, whose image replaced the
    row-major one): the padded layers in order (W1, the hidden layers, W_L,
    C1 = [C1s; C1g], the middle color layers, C_last), each as
    `fused_mlp.tf32_chunks` in the parts and chunks of `tf32_layers`: every
    chunk of an H-wide layer fills one stage of the ring (128 H bytes), the
    color layers' chunks 16 KB, C_last's first 4 columns f32 row-major at
    the end; and its cache entry is not the bf16 one. (tests/
    test_torch_tf32_chain.py reads every weight back.)"""
    _, _, sn, cn, _ = _nets(hidden=hidden, n_sig=4, rows=1)
    sn_t, cn_t = _t(sn), _t(cn)
    m = pm._prepare(sn_t, cn_t, torch.float32)
    image = m["image"]
    assert image.dtype == torch.float32 and image.dim() == 1
    layers = pm.tf32_layers(m)
    parts = pm.RING_F32[hidden][0]
    assert [(tuple(w.shape), p, k) for w, p, k in layers] == [
        ((80, hidden), 1, 2), ((hidden, hidden), parts, 2 * parts),
        ((hidden, hidden), parts, 2 * parts), ((hidden, 16), 1, hidden // 8),
        ((32, 64), 1, 4), ((64, 64), 1, 4), ((64, 4), None, None)]
    off = 0
    for w, p, k in layers:
        if p is None:
            assert torch.equal(image[off:], w.reshape(-1))
            off += w.numel()
            continue
        chunk = 2 * 8 * k * (w.shape[1] // p)        # floats: hi and lo
        assert 4 * chunk == (128 * hidden if w.shape[1] in (hidden, 16)
                             else 16384)
        got = torch.cat(k4.tf32_chunks(w, k, p))
        assert got.numel() % chunk == 0
        assert torch.equal(image[off:off + got.numel()], got)
        off += got.numel()
    assert off == image.numel()
    assert 4 * off == pm.f32_stream_bytes(hidden, 2, 1)
    torch.testing.assert_close(layers[4][0][16 + 1:], cn_t[0][16:], rtol=0,
                               atol=0)
    assert not layers[4][0][16].any()
    assert pm._prepare(sn_t, cn_t)["image"].dtype == torch.bfloat16
    assert pm.LAYOUT[torch.float32] != pm.LAYOUT[torch.bfloat16]