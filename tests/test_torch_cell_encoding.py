"""The cell layout of the hash grid (nerfsafetyvalidation_tpu_torch/ops/
hash_encoding.py: `cell_sizes`, `build_cell_table`,
`hash_grid_encode_cell`) against the JAX package's on the CPU:

  * the cell table bit for bit, in float32 and bfloat16, on a toy spec with
    dense levels and hashed levels, one of whose cells are all enumerated
    (fewer than 4 * size) and two of whose cells are drawn by numpy: in
    both, many cells land in one row, and the last of them must win, as
    JAX's scatter keeps the last of duplicate indices on the CPU;
  * the cell encode from the same table, in float32 (the blend's eight
    products summed in another order: bound 1e-6) and with a bfloat16
    table (each product rounded to bfloat16, the sum in float32, rounded
    once: bound one bfloat16 step of the output, 2^-8 relative), with all
    levels and with `max_level`, on points inside and outside the box;
  * on dense levels the cell encode is the corner encode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops import hash_encoding as J
from nerfsafetyvalidation_tpu_torch.ops import hash_encoding as T

torch.set_num_threads(1)

# resolutions 4, 9, 18, 36 (levels 1-3 hashed into 256 rows; level 1's
# 729 cells are enumerated, levels 2-3 draw 1,024 cells each)
SPEC = dict(num_levels=4, level_dim=2, base_resolution=4,
            log2_hashmap_size=8, desired_resolution=36)
BOUND = 1.5


def _specs(**kw):
    return J.HashGridSpec.make(**kw), T.HashGridSpec.make(**kw)


def _points(n, seed):
    """n points, a tenth of them outside the box (and a few on its
    faces)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-BOUND, BOUND, (n, 3))
    x[: n // 10] *= 1.3
    x[n // 10: n // 10 + 8] = np.sign(x[n // 10: n // 10 + 8]) * BOUND
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def tables():
    """The JAX and port cell tables of one corner table, float32 and
    bfloat16 (the bfloat16 pair as float32 arrays of the same values)."""
    js, ts = _specs(**SPEC)
    emb = np.random.default_rng(0).uniform(
        -1, 1, (js.offsets[-1], 2)).astype(np.float32)
    out = {"emb": emb}
    for name, jd, td in (("f32", jnp.float32, torch.float32),
                         ("bf16", jnp.bfloat16, torch.bfloat16)):
        jt = J.build_cell_table(jnp.asarray(emb).astype(jd), js)
        tt = T.build_cell_table(torch.from_numpy(emb).to(td), ts)
        out[name] = (np.asarray(jt.astype(jnp.float32)), tt.float().numpy())
    return out


def test_spec_has_the_cases():
    """The toy spec's levels: dense, enumerated-and-colliding, drawn."""
    js, _ = _specs(**SPEC)
    sizes, offsets, strides = J.cell_sizes(js)
    assert js.use_hash == (False, True, True, True)
    res = js.resolutions
    assert res[0] ** 3 == sizes[0]
    assert sizes[1] < res[1] ** 3 <= 4 * sizes[1]
    assert all(r ** 3 > 4 * s for r, s in zip(res[2:], sizes[2:]))
    assert T.cell_sizes(_specs(**SPEC)[1]) == (sizes, offsets, strides)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cell_table_bit_equal(tables, dtype):
    """Every row the same bits, the zero rows (no cell lands there) too."""
    jt, tt = tables[dtype]
    assert jt.shape == tt.shape
    np.testing.assert_array_equal(tt.view(np.uint32), jt.view(np.uint32))
    # the enumerated hashed level: its 729 cells fill every one of its 256
    # rows, so rows take several cells
    js, _ = _specs(**SPEC)
    sizes, offsets, _ = J.cell_sizes(js)
    filled = np.abs(jt[offsets[1]:offsets[2]]).sum(-1) > 0
    assert filled.sum() == sizes[1] < js.resolutions[1] ** 3


def test_cell_table_last_write_wins():
    """Where two cells share a row, the row holds the later cell's
    corners: a first-wins build would differ from JAX's."""
    js, ts = _specs(**SPEC)
    emb = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (js.offsets[-1], 2)).astype(np.float32))
    table = T.build_cell_table(emb, ts)
    sizes, offsets, _ = T.cell_sizes(ts)
    lvl = 1
    cells = torch.from_numpy(T._level_cells(ts, lvl, sizes[lvl]).astype(
        np.int64))
    rows = T._cell_rows(ts, cells, lvl)
    first = {}
    for i, r in enumerate(rows.tolist()):
        first.setdefault(r, i)
    dup = [(r, i) for r, i in first.items()
           if int((rows == r).sum()) > 1][:20]
    assert dup
    bits = torch.from_numpy(T._corner_bits(3).astype(np.int64))
    for r, i in dup:
        grid = (cells[i] + bits)[None, None].expand(1, lvl + 1, 8, 3)
        corners = T._level_rows(ts, grid)[0, lvl]
        assert not torch.equal(table[r], emb[corners].reshape(-1))
    last = rows.shape[0] - 1 - torch.flip(rows, [0]).tolist().index(
        dup[0][0])
    grid = (cells[last] + bits)[None, None].expand(1, lvl + 1, 8, 3)
    assert torch.equal(table[dup[0][0]],
                       emb[T._level_rows(ts, grid)[0, lvl]].reshape(-1))


@pytest.mark.parametrize("max_level", [None, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cell_encode_matches_jax(tables, dtype, max_level):
    """The encode of 3,000 points from the same table."""
    js, ts = _specs(**SPEC)
    x = _points(3000, 2)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    jt, tt = tables[dtype]
    got = T.hash_grid_encode_cell(torch.from_numpy(tt).to(td),
                                  torch.from_numpy(x), ts, bound=BOUND,
                                  max_level=max_level)
    want = J.hash_grid_encode_cell(jnp.asarray(jt).astype(jd),
                                   jnp.asarray(x), js, bound=BOUND,
                                   max_level=max_level)
    assert got.dtype == td and got.shape == (3000, js.output_dim)
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    oob = (np.abs(x) > BOUND).any(-1)
    assert oob.sum() > 100 and (got[oob] == 0).all()
    if max_level is not None:
        assert (got[:, 2 * max_level:] == 0).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)


def test_cell_equals_corner_on_dense_levels():
    """A spec whose levels are all dense: the cell encode of its table
    equals the corner encode (the same eight features and weights,
    blended alike), float32."""
    _, ts = _specs(num_levels=3, level_dim=2, base_resolution=4,
                   log2_hashmap_size=16, desired_resolution=16)
    assert not any(ts.use_hash)
    emb = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (ts.offsets[-1], 2)).astype(np.float32))
    x = torch.from_numpy(_points(4000, 4))
    cell = T.hash_grid_encode_cell(T.build_cell_table(emb, ts), x, ts,
                                   bound=BOUND)
    corner = T.hash_grid_encode(emb, x, ts, bound=BOUND)
    torch.testing.assert_close(cell, corner, rtol=0, atol=1e-7)
