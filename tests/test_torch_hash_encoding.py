"""The corner-layout hash-grid encoder of the port
(nerfsafetyvalidation_tpu_torch/ops/hash_encoding.py) against the JAX
package's (nerfsafetyvalidation_tpu/ops/hash_encoding.py) on the CPU:
the spec and the corner rows exactly, the encode in f32 and bf16 with and
without a level mask, and the encode of the committed reference backbone's
trained table (bench_assets/refbb.ckpt)."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops import hash_encoding as J
from nerfsafetyvalidation_tpu_torch import flagship as F
from nerfsafetyvalidation_tpu_torch.ops import hash_encoding as T

torch.set_num_threads(1)

# bench.py's reference spec (16 levels from 16 to 2048, 2^19 rows), and
# small specs with dense and hashed levels
SPECS = {
    "ref": dict(num_levels=16, level_dim=2, base_resolution=16,
                log2_hashmap_size=19, desired_resolution=2048),
    "small": dict(num_levels=6, level_dim=2, base_resolution=4,
                  log2_hashmap_size=10, desired_resolution=64),
    "small_ac": dict(num_levels=6, level_dim=2, base_resolution=4,
                     log2_hashmap_size=10, desired_resolution=64,
                     align_corners=True),
    "tiled": dict(num_levels=4, level_dim=4, base_resolution=3,
                  log2_hashmap_size=8, per_level_scale=1.5,
                  gridtype="tiled"),
}
FIELDS = ("input_dim", "num_levels", "level_dim", "per_level_scale",
          "base_resolution", "log2_hashmap_size", "gridtype",
          "align_corners", "aligned", "scales", "resolutions", "offsets",
          "sizes", "use_hash", "strides", "output_dim", "n_params")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_equals_jax(name):
    s_j = J.HashGridSpec.make(**SPECS[name])
    s_t = T.HashGridSpec.make(**SPECS[name])
    for f in FIELDS:
        assert getattr(s_t, f) == getattr(s_j, f), f
    if name == "ref":
        assert s_t.offsets[-1] == 6119864
        assert 0 < sum(s_t.use_hash) < s_t.num_levels


def test_aligned_spec_is_not_ported():
    with pytest.raises(NotImplementedError):
        T.HashGridSpec.make(aligned=True)


def _grid_points(spec, n, seed):
    """Positions in [0, 1]^3, u = 0 and u = 1 among them, as (u, the
    corner grid of every level [n, L, 8, 3] uint32)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    u[0] = 0.0
    u[1] = 1.0
    u[2] = (0.0, 1.0, 0.5)
    bits = J._corner_bits(3)
    grids = []
    for lvl in range(spec.num_levels):
        pos = u * np.float32(spec.scales[lvl]) \
            + (0.0 if spec.align_corners else np.float32(0.5))
        grids.append(np.floor(pos).astype(np.uint32)[:, None, :] + bits)
    return u, np.stack(grids, axis=1)


@pytest.mark.parametrize("name", ["ref", "small", "small_ac", "tiled"])
def test_level_rows_exact(name):
    """Every level's corner rows, hashed and dense, equal JAX's exactly;
    one level at a time and all levels at once."""
    spec_j = J.HashGridSpec.make(**SPECS[name])
    spec_t = T.HashGridSpec.make(**SPECS[name])
    _, grid = _grid_points(spec_j, 500, seed=1)
    all_t = T._level_rows(spec_t, torch.from_numpy(grid.astype(np.int64)))
    for lvl in range(spec_j.num_levels):
        want = np.asarray(J._level_rows(spec_j, lvl,
                                        jnp.asarray(grid[:, lvl])))
        np.testing.assert_array_equal(all_t[:, lvl].numpy(), want)
    one = T._level_rows(spec_t, torch.from_numpy(
        grid[:, :1].astype(np.int64)))
    np.testing.assert_array_equal(one[:, 0].numpy(), all_t[:, 0].numpy())
    assert int(all_t.max()) < spec_t.offsets[-1] and int(all_t.min()) >= 0


def _encode_both(name, dtype, max_level, n=1500, seed=2):
    spec_j = J.HashGridSpec.make(**SPECS[name])
    spec_t = T.HashGridSpec.make(**SPECS[name])
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, (spec_j.offsets[-1], spec_j.level_dim)) \
        .astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    x[0], x[1] = -1.0, 1.0                   # u = 0 and u = 1
    x[2] = (1.0001, 0.0, 0.0)                # outside the box: zero
    x[3] = (0.0, -1.5, 0.0)
    e_j = np.asarray(J.hash_grid_encode(
        jnp.asarray(emb).astype(dtype), jnp.asarray(x), spec_j,
        max_level=max_level)).astype(np.float32)
    e_t = T.hash_grid_encode(torch.from_numpy(emb).to(getattr(torch, dtype)),
                             torch.from_numpy(x), spec_t,
                             max_level=max_level)
    assert e_t.dtype == getattr(torch, dtype)
    assert tuple(e_t.shape) == (n, spec_t.output_dim)
    e_t = e_t.float().numpy()
    assert not e_t[2:4].any()
    return e_t, e_j, spec_t


@pytest.mark.parametrize("max_level", [None, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["small", "small_ac", "ref"])
def test_encode_matches_jax(name, dtype, max_level):
    e_t, e_j, spec = _encode_both(name, dtype, max_level)
    if max_level is not None:
        assert not e_t[:, max_level * spec.level_dim:].any()
    if dtype == "float32":
        # the 8-corner sums in another order; measured 4.8e-7 at most
        np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=2e-6)
    else:
        # one bf16 step (2^-8 relative), the bound of the mip-fold blend
        # (test_torch_mip_encoding.py), where JAX may keep a product in
        # f32; measured bit-exact here
        np.testing.assert_allclose(e_t, e_j, rtol=2.0 ** -8, atol=1e-6)


def test_encode_in_chunks(monkeypatch):
    """The chunked encode equals the encode in one piece."""
    spec = T.HashGridSpec.make(**SPECS["small"])
    rng = np.random.default_rng(3)
    emb = torch.from_numpy(rng.normal(0, 1, (spec.offsets[-1], 2))
                           .astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (1000, 3)).astype(np.float32))
    whole = T.hash_grid_encode(emb, x, spec)
    monkeypatch.setattr(T, "ENCODE_CHUNK", 300)
    assert torch.equal(T.hash_grid_encode(emb, x.reshape(10, 100, 3), spec),
                       whole.reshape(10, 100, spec.output_dim))


@pytest.mark.parametrize("max_level", [None, F.REF_MAX_LEVEL])
def test_reference_backbone_encode_bit_exact(max_level):
    """bench_assets/refbb.ckpt's trained table, cast to bf16 as the JAX
    encode_pos casts it: the encoding of 2,048 points is bit-exact."""
    with open(F.REF_CKPT, "rb") as f:
        emb = np.asarray(pickle.load(f)["model"]["encoder"]["embeddings"]) \
            .astype(np.float32)
    spec_j = J.HashGridSpec.make(**SPECS["ref"])
    spec_t = T.HashGridSpec.make(**SPECS["ref"])
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    e_j = np.asarray(J.hash_grid_encode(
        jnp.asarray(emb).astype(jnp.bfloat16), jnp.asarray(x), spec_j,
        max_level=max_level)).astype(np.float32)
    e_t = T.hash_grid_encode(torch.from_numpy(emb).to(torch.bfloat16),
                             torch.from_numpy(x), spec_t,
                             max_level=max_level).float().numpy()
    assert np.abs(e_j).max() > 0.01
    np.testing.assert_array_equal(e_t, e_j)
