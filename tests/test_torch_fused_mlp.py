"""Kernel K4 of the port (ops/hopper/fused_mlp.py) against the JAX package
on the CPU: its plain version `fused_mlp_plain` against the JAX Pallas
kernel `fused_mlp`, run in interpret mode as tests/test_fused_mlp.py runs
it, and against the XLA chain `_xla_mlp`, which keeps the last layer in
f32; the wrapper's dispatch (a CPU tensor takes the plain version, any
other tensor never does) and its packing of the weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops.pallas import fused_mlp as J
from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as K

torch.set_num_threads(1)

# the hash-grid field's sigma and color nets, and the FFMLP topology's
NETS = {"sigma": [32, 64, 16], "color": [31, 64, 64, 3],
        "ff_sigma": [32, 64, 64, 16]}


def _chain(dims, rows=300, seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 1.5 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    x = rng.normal(0, 1.0, (rows, dims[0])).astype(np.float32)
    return x, ws


def _tol(dtype):
    # f32: JAX's own kernel-vs-XLA tolerance (tests/test_fused_mlp.py).
    # bf16: every layer rounds to bf16; where the sum order lands an output
    # on the neighbouring bf16 value (relative step 2^-8), later layers move
    # by a fraction of that step; bounded at the step itself
    return (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -8, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_plain_matches_jax_kernel(net, dtype):
    x, ws = _chain(NETS[net], rows=257)
    want = np.asarray(J.fused_mlp(jnp.asarray(x),
                                  [jnp.asarray(w) for w in ws],
                                  compute_dtype=getattr(jnp, dtype),
                                  interpret=True))
    got = K.fused_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                      getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    if dtype == "bfloat16":      # every output is a bf16 value
        g = got.numpy()
        np.testing.assert_array_equal(
            torch.from_numpy(g).to(torch.bfloat16).float().numpy(), g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_plain_vs_xla_chain(net, dtype):
    """`_xla_mlp` is the same chain with the last layer kept in f32: the
    plain version equals it rounded to the compute dtype there."""
    x, ws = _chain(NETS[net], rows=211, seed=1)
    want = np.array(J._xla_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                 getattr(jnp, dtype)))
    got = K.fused_mlp_plain(torch.from_numpy(x),
                            [torch.from_numpy(w) for w in ws],
                            getattr(torch, dtype))
    rtol, atol = _tol(dtype)
    want_rounded = torch.from_numpy(want).to(getattr(torch, dtype)).float()
    np.testing.assert_allclose(got.numpy(), want_rounded.numpy(), rtol=rtol,
                               atol=atol)
    if dtype == "bfloat16":      # the one stated difference shows
        assert np.abs(got.numpy() - want).max() > 0


def test_cpu_wrapper_is_the_plain_version():
    x, ws = _chain(NETS["color"], rows=40)
    x_t, ws_t = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    before = K.LAUNCHES
    torch.testing.assert_close(K.fused_mlp(x_t, ws_t),
                               K.fused_mlp_plain(x_t, ws_t), rtol=0, atol=0)
    assert K.LAUNCHES == before          # the plain path is never counted


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_non_cpu_tensor_never_takes_the_plain_path(dtype):
    """The meta device has no kernel, so the wrapper must raise, whatever
    the compute dtype."""
    ws = [torch.empty((32, 64), device="meta"),
          torch.empty((64, 16), device="meta")]
    with pytest.raises(ValueError):
        K.fused_mlp(torch.empty((8, 32), dtype=torch.bfloat16,
                                device="meta"), ws, dtype)


def test_prepared_weights_are_packed_and_padded():
    _, ws = _chain(NETS["color"])
    ws_t = [torch.from_numpy(w) for w in ws]
    widths, packed = K._prepare(ws_t)
    assert widths == [31, 64, 64, 3]
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() == 32 * 64 + 64 * 64 + 64 * 16
    c1 = packed[:32 * 64].reshape(32, 64)
    c3 = packed[32 * 64 + 64 * 64:].reshape(64, 16)
    torch.testing.assert_close(c1[:31], ws_t[0].to(torch.bfloat16),
                               rtol=0, atol=0)
    assert not c1[31].any() and not c3[:, 3:].any()
    assert K._prepare(ws_t)[1] is packed          # built once per weights
    with torch.inference_mode():                  # inference-mode weights
        assert K._prepare([torch.from_numpy(w) for w in ws])[0] == widths


@pytest.mark.parametrize("shapes", [[(32, 64), (16, 15)],
                                    [(32, 129), (129, 3)],
                                    [(8, 8)] * 9])
def test_shapes_beyond_the_kernel_raise(shapes):
    """Weights that do not chain, a width past 128, or more than 8
    layers."""
    with pytest.raises(ValueError):
        K._prepare([torch.zeros(s) for s in shapes])


def test_shared_memory_of_the_ref_nets():
    """The block's shared memory (the kernel's formula): the sigma net and
    the color net fit under the 48 KB a block gets without opting in."""
    assert K._smem_bytes(NETS["sigma"]) == 2 * 3072 + 4 * 2 * 16 * 72 * 2 \
        + 4 * 1024
    assert K._smem_bytes(NETS["color"]) < 48 * 1024


def test_cache_keeps_its_weights_alive():
    """A cached entry holds its weights, so freed weights cannot hand their
    storage (and with it the cache key) to new weights of the same shape:
    new weights always get their own packed buffer."""
    packed = []
    for seed in range(4):
        _, ws = _chain(NETS["sigma"], seed=seed)
        ws_t = [torch.from_numpy(w) for w in ws]
        packed.append(K._prepare(ws_t)[1])
        want = torch.cat([ws_t[0].to(torch.bfloat16).reshape(-1),
                          ws_t[1].to(torch.bfloat16).reshape(-1)])
        torch.testing.assert_close(packed[-1], want, rtol=0, atol=0)
        del ws, ws_t
