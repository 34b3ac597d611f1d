"""The port's mip-fold encoder against the JAX package's, on the CPU.

A small spec (5 levels of 2 channels from base 4, dense up to 16, hashed
32/64 into 2^10 rows) with weights drawn by numpy from a seed; hash rows
also at the flagship's spec (finest scale 2048, 2^19 rows), where the
uint32 products wrap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops import mip_encoding as J
from nerfsafetyvalidation_tpu_torch.ops import mip_encoding as T

torch.set_num_threads(1)

SMALL = dict(pyramid_scales=(4, 8, 16), pyramid_channels=2,
             mip_scales=(32, 64), mip_channels=2, log2_hashmap_size=10)
FLAGSHIP = dict(pyramid_scales=(16, 32, 64, 128), pyramid_channels=4,
                mip_scales=(256, 512, 1024, 2048), mip_channels=4,
                log2_hashmap_size=19)
# bf16 results may land one bf16 step (2^-8 relative) apart: the f32 sums
# behind them run in another order in the two frameworks
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6


def _params(spec, seed=0):
    rng = np.random.default_rng(seed)
    return {"pyramid": [rng.normal(0, 0.5, ((s + 1) ** 3,
                                            spec.pyramid_channels))
                        .astype(np.float32) for s in spec.pyramid_scales],
            "hash": rng.normal(0, 0.5, (spec.hash_rows, spec.hash_width))
            .astype(np.float32)}


def _jax(params):
    return {"pyramid": [jnp.asarray(g) for g in params["pyramid"]],
            "hash": jnp.asarray(params["hash"])}


def _torch(params):
    return {"pyramid": [torch.as_tensor(g) for g in params["pyramid"]],
            "hash": torch.as_tensor(params["hash"])}


def _np(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("kw", [SMALL, FLAGSHIP], ids=["small", "flagship"])
def test_hash_rows_exact(kw):
    rng = np.random.default_rng(1)
    S = kw["mip_scales"][-1]
    cell = rng.integers(0, S, (4096, 3)).astype(np.int32)
    cell[:8] = S - 1                        # the largest products
    got = T._hash_rows_for(torch.as_tensor(cell), T.MipFoldSpec(**kw))
    ref = J._hash_rows_for(jnp.asarray(cell), J.MipFoldSpec(**kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("fold_scale", [0, 8])
def test_materialize_dense(fold_scale):
    spec_t = T.MipFoldSpec(**SMALL, fold_scale=fold_scale)
    spec_j = J.MipFoldSpec(**SMALL, fold_scale=fold_scale)
    p = _params(spec_t)
    got = T.materialize_dense(_torch(p), spec_t)
    ref = J.materialize_dense(_jax(p), spec_j)
    # f32: the same products and sums, up to contraction into FMAs
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_fold_table(dtype):
    spec_t, spec_j = T.MipFoldSpec(**SMALL), J.MipFoldSpec(**SMALL)
    p = _params(spec_t)
    got = T.build_mip_fold_table(_torch(p), spec_t,
                                 dtype=getattr(torch, dtype))
    ref = J.build_mip_fold_table(_jax(p), spec_j, dtype=getattr(jnp, dtype))
    assert tuple(got.shape) == (16 ** 3, 8 * spec_t.dense_channels)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), _np(ref),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mip_fold_encode(dtype):
    spec_t, spec_j = T.MipFoldSpec(**SMALL), J.MipFoldSpec(**SMALL)
    p = _params(spec_t)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.05, 1.05, (3000, 3)).astype(np.float32)
    x[:4] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0], [1.0, -0.5, 1.02]]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # one fold table for both, so the test holds the encode alone
    fold = J.build_mip_fold_table(_jax(p), spec_j, dtype=jdt)
    ref = J.mip_fold_encode(_jax(p), jnp.asarray(x), spec_j, bound=1.0,
                            fold_table=fold, compute_dtype=jdt)
    got = T.mip_fold_encode(_torch(p), torch.as_tensor(x), spec_t,
                            bound=1.0,
                            fold_table=torch.as_tensor(_np(fold)).to(tdt),
                            compute_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (3000, 10)
    oob = (np.abs(x) > 1).any(-1)
    assert oob.sum() > 100 and not got[torch.as_tensor(oob)].any()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), _np(ref),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)


def test_encode_is_trilinear_in_the_fold():
    """Independent of JAX: at the dense part, the fold-table encode equals
    trilinear interpolation of the materialized volume."""
    spec = T.MipFoldSpec(**SMALL)
    p = _torch(_params(spec))
    F, Cd = spec.F, spec.dense_channels
    fold = T.build_mip_fold_table(p, spec, dtype=torch.float32)
    x = torch.as_tensor(np.random.default_rng(3).uniform(
        -1, 1, (500, 3)).astype(np.float32))
    got = T.mip_fold_encode(p, x, spec, fold_table=fold)[:, :Cd]
    V = T.materialize_dense(p, spec).reshape(F + 1, F + 1, F + 1, Cd)
    pos = (x.double() + 1) / 2 * F
    c = torch.clamp(torch.floor(pos), 0, F - 1)
    fr = pos - c
    c = c.long()
    ref = torch.zeros((500, Cd), dtype=torch.float64)
    for bx in (0, 1):
        for by in (0, 1):
            for bz in (0, 1):
                w = ((fr[:, 0] if bx else 1 - fr[:, 0])
                     * (fr[:, 1] if by else 1 - fr[:, 1])
                     * (fr[:, 2] if bz else 1 - fr[:, 2]))
                ref += w[:, None] * V[c[:, 0] + bx, c[:, 1] + by,
                                      c[:, 2] + bz].double()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
