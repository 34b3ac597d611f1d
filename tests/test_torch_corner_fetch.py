"""The corner fetches "pair", "quad" and "cube" of the port's mip-fold
training encode (ops/mip_encoding.py `_dense_corner_fetch`,
`corner_windows`) against the JAX package's, on the CPU: the 8 corner rows
of each cell, bit-exact, and their vector-Jacobian product; and
`mip_fold_encode` with each `train_gather` against "corner8" and against
JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops import mip_encoding as J
from nerfsafetyvalidation_tpu_torch.ops import mip_encoding as T

torch.set_num_threads(1)

MODES = ["corner8", "pair", "quad", "cube"]
F, CD, N = 8, 4, 700


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1)
    table = rng.normal(size=((F + 1) ** 3, CD)).astype(np.float32)
    # every cell of the grid, the edges included, and random ones
    edge = np.array([[0, 0, 0], [F - 1, F - 1, F - 1], [F - 1, 0, F - 1]])
    ci = np.concatenate([edge, rng.integers(0, F, (N - 3, 3))]).astype(
        np.int32)
    r = rng.normal(size=(N, 8, CD)).astype(np.float32)
    return table, ci, r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_corner_rows_bit_exact_against_jax(case, mode, dtype):
    table, ci, _ = case
    want = J._dense_corner_fetch(jnp.asarray(table).astype(dtype),
                                 jnp.asarray(ci), F, CD, mode)
    got = T._dense_corner_fetch(torch.from_numpy(table).to(
        getattr(torch, dtype)), torch.from_numpy(ci).long(), F, CD, mode)
    assert got.shape == (N, 8, CD) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("mode", MODES)
def test_corner_vjp_against_jax(case, mode):
    """The cotangent summed back onto each grid point. "corner8" sums
    the same terms in the same order as JAX (bit-exact); the window modes
    sum each window, then the windows, in another order. Measured 1.9e-6
    apart at gradients up to 15.4 (1.2e-7 of the largest); bounded at 1e-6
    of the largest."""
    table, ci, r = case
    _, vjp = jax.vjp(lambda t: J._dense_corner_fetch(
        t, jnp.asarray(ci), F, CD, mode), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(r))[0])
    t = torch.tensor(table, requires_grad=True)
    T._dense_corner_fetch(t, torch.from_numpy(ci).long(), F, CD,
                          mode).backward(torch.from_numpy(r))
    atol = 0.0 if mode == "corner8" else 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=atol)


SMALL = dict(pyramid_scales=(4, 8, 16), pyramid_channels=2,
             mip_scales=(32, 64), mip_channels=2, log2_hashmap_size=10)


@pytest.fixture(scope="module")
def encode_case():
    rng = np.random.default_rng(2)
    spec = J.MipFoldSpec(**SMALL)
    p = {"pyramid": [rng.normal(0, 0.5, ((s + 1) ** 3, 2)).astype(np.float32)
                     for s in SMALL["pyramid_scales"]],
         "hash": rng.normal(0, 0.5, (spec.hash_rows, spec.hash_width))
         .astype(np.float32)}
    x = rng.uniform(-1.05, 1.05, (1500, 3)).astype(np.float32)
    r = rng.normal(size=(1500, spec.output_dim)).astype(np.float32)
    return p, x, r


def _torch_encode(p, x, r, mode, dtype):
    """(encoding, gradients of sum(enc * r) over the pyramid and table)."""
    pt = {"pyramid": [torch.tensor(a, requires_grad=True)
                      for a in p["pyramid"]],
          "hash": torch.tensor(p["hash"], requires_grad=True)}
    enc = T.mip_fold_encode(pt, torch.from_numpy(x), T.MipFoldSpec(**SMALL),
                            compute_dtype=dtype, train_gather=mode)
    (enc.float() * torch.from_numpy(r)).sum().backward()
    return enc.detach(), [a.grad for a in pt["pyramid"] + [pt["hash"]]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["pair", "quad", "cube"])
def test_encode_equals_corner8(encode_case, mode, dtype):
    """Every corner fetch gives "corner8"'s encoding bit for bit (the same
    corner values, blended alike). The gradients differ only by the sum
    order of the window route's backward. In float32: measured 9.8e-8 of
    the largest at most, bounded at 1e-6. In bfloat16 the corner
    cotangents are summed onto the grid points in bf16, each point's up to
    8 windows in another order, so up to 8 roundings of 2^-9 of a partial
    sum: measured 6.3e-3 of the largest, bounded at twice 8 * 2^-9."""
    p, x, r = encode_case
    enc8, g8 = _torch_encode(p, x, r, "corner8", dtype)
    enc, g = _torch_encode(p, x, r, mode, dtype)
    assert torch.equal(enc, enc8)
    tol = 1e-6 if dtype == torch.float32 else 2 * 8 * 2 ** -9
    for a, b in zip(g, g8):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * scale


@pytest.mark.parametrize("mode", ["pair", "quad", "cube"])
def test_encode_matches_jax(encode_case, mode):
    """Against JAX's mip_fold_encode with the same train_gather, f32: the
    encodings within 1e-6 (XLA contracts the blend's products and sums
    into FMAs on the CPU; tests/test_torch_mip_train.py; measured
    1.2e-7), the gradients within 1e-6 of the largest (the window route's
    sum order; measured 9.8e-8)."""
    p, x, r = encode_case
    spec = J.MipFoldSpec(**SMALL)

    def loss(pp):
        e = J.mip_fold_encode(pp, jnp.asarray(x), spec, train_gather=mode)
        return jnp.sum(e * r), e

    (_, enc_j), g_j = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p))
    enc, g = _torch_encode(p, x, r, mode, torch.float32)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), rtol=0,
                               atol=1e-6)
    for a, b in zip(g, [*g_j["pyramid"], g_j["hash"]]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


def test_windows_are_one_read_of_a_view(case):
    """corner_windows reads [N, 2, 2, 2, Cd] through a view of the table
    (no copy of it) and gives the same corners in every mode."""
    table, ci, _ = case
    t = torch.from_numpy(table)
    ci_t = torch.from_numpy(ci).long()
    cubes = [T.corner_windows(t, ci_t, F, CD, m)
             for m in ("pair", "quad", "cube")]
    x, y, z = ci_t.unbind(-1)
    g = t.reshape(F + 1, F + 1, F + 1, CD)
    for bx in (0, 1):
        for by in (0, 1):
            for bz in (0, 1):
                want = g[x + bx, y + by, z + bz]
                for c in cubes:
                    assert torch.equal(c[:, bx, by, bz], want)
