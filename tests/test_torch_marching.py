"""The port's occupancy marcher and bitfield helpers against the JAX
package's, on the CPU: `march_rays` (one loop, phased and resumed after a
permutation, skip grid, paired emission), `composite_marched`, `packbits`,
`occupancy_to_skip_grid` and `bitfield_lookup`.

The occupancy is a 32^3 grid (two cascades where the skip grid is built)
holding a ball and scattered cells, made by numpy from a seed; the rays
start outside the box and cross it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops import marching as JM
from nerfsafetyvalidation_tpu.ops import ray_ops as JR
from nerfsafetyvalidation_tpu_torch.ops import marching as TM
from nerfsafetyvalidation_tpu_torch.ops import ray_ops as TR

torch.set_num_threads(1)

G = 32


def _grid(cascade=1, seed=0):
    """Density grid [cascade, G^3] in morton order: a ball of radius 0.4
    and 2% scattered cells, densities 0..20."""
    rng = np.random.default_rng(seed)
    g = np.arange(G)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    c = 2.0 * (np.stack([xx, yy, zz], -1) + 0.5) / G - 1.0
    dens = np.where(np.linalg.norm(c, axis=-1) < 0.4, 15.0, 0.0)
    dens = np.where(rng.random(dens.shape) < 0.02, 20.0, dens)
    dens = dens * rng.uniform(0.5, 1.0, dens.shape)
    code = np.asarray(JR.morton3d(jnp.asarray(
        np.stack([xx.ravel(), yy.ravel(), zz.ravel()], -1))))
    grid = np.zeros((cascade, G ** 3), np.float32)
    grid[:, code] = dens.reshape(-1)
    return grid


def _rays(n=256, seed=1, exact=True):
    """Rays from z = -2.5 into the box. exact: direction components of 0
    or +-2^-k (not normalised; the marcher does not need it), so every
    product t * d is exact and the march takes the same path whether the
    compiler contracts o + t * d into an FMA (XLA on the CPU does) or not
    (PyTorch's separate kernels). Otherwise normalised random directions."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                  np.full(n, -2.5)], -1).astype(np.float32)
    if exact:
        side = np.array([0.0, 0.0625, -0.0625, 0.125, -0.125, 0.25, -0.25])
        d = np.stack([rng.choice(side, n), rng.choice(side, n),
                      np.ones(n)], -1).astype(np.float32)
    else:
        d = np.stack([rng.normal(0, 0.15, n), rng.normal(0, 0.15, n),
                      np.ones(n)], -1)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32)
    aabb = jnp.asarray([-1.0, -1, -1, 1, 1, 1])
    nr, fr = JR.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), aabb, 0.2)
    return o, d, np.asarray(nr), np.asarray(fr)


@pytest.fixture(scope="module")
def occupancy():
    grid = _grid()
    gj = jnp.asarray(grid)
    bits = np.array(JR.packbits(gj, 8.0))
    skip = np.array(JR.occupancy_to_skip_grid(gj > 8.0, G))
    return bits, skip


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _check(got, ref):
    """count, mask and ts exact; the fields derived from ts after the loop
    to f32 rounding (XLA may contract them into FMAs)."""
    for k in ("count", "mask", "ts"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("deltas", "rs", "xyzs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


CASES = {"bitfield": dict(skip=False, samples_per_hit=1, dt_gamma=0.0),
         "skip_paired": dict(skip=True, samples_per_hit=2,
                             dt_gamma=1.0 / 64),
         "bitfield_paired": dict(skip=False, samples_per_hit=2,
                                 dt_gamma=1.0 / 64)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_march_rays_matches_jax(occupancy, case):
    bits, skip = occupancy
    c = CASES[case]
    o, d, nr, fr = _rays()
    kw = dict(bound=1.0, cascade=1, grid_size=G, max_samples=16,
              max_steps=128, dt_gamma=c["dt_gamma"],
              samples_per_hit=c["samples_per_hit"])
    ref = JM.march_rays(*_j(o, d, nr, fr, bits),
                        skip_grid=jnp.asarray(skip) if c["skip"] else None,
                        **kw)
    got = TM.march_rays(*_t(o, d, nr, fr, bits),
                        skip_grid=torch.from_numpy(skip) if c["skip"]
                        else None, **kw)
    assert int(np.asarray(ref["count"]).sum()) > 500   # rays do hit
    _check(got, ref)


def test_phased_resumed_march_matches_jax(occupancy):
    """Phase 1 of a fixed 7 iterations, the rays reversed, phase 2 resumed
    from the permuted carry; and the same as one loop."""
    bits, skip = occupancy
    o, d, nr, fr = _rays(seed=2)
    kw = dict(bound=1.0, cascade=1, grid_size=G, max_samples=16,
              max_steps=128, dt_gamma=1.0 / 64, samples_per_hit=2)
    perm = np.arange(o.shape[0])[::-1].copy()

    def run(M, arr, skip_grid):
        a = arr(o, d, nr, fr, bits)
        _, carry = M.march_rays(*a, skip_grid=skip_grid, fixed_iters=7,
                                return_carry=True, **kw)
        p = arr(perm)[0]
        return M.march_rays(a[0][p], a[1][p], a[2][p], a[3][p], a[4],
                            skip_grid=skip_grid,
                            resume_carry=tuple(x[p] for x in carry), **kw)

    ref = run(JM, _j, jnp.asarray(skip))
    got = run(TM, _t, torch.from_numpy(skip))
    _check(got, ref)
    whole = TM.march_rays(*_t(o, d, nr, fr, bits),
                          skip_grid=torch.from_numpy(skip), **kw)
    p = torch.from_numpy(perm)
    for k in ("count", "ts"):
        torch.testing.assert_close(got[k], whole[k][p], rtol=0, atol=0)


def test_march_stops_at_max_steps(occupancy):
    """The host asks for any(active) every CHECK_EVERY iterations only;
    the loop still stops at a max_steps that is not a multiple of it."""
    bits, _ = occupancy
    o, d, nr, fr = _rays(n=64, seed=3)
    kw = dict(bound=1.0, cascade=1, grid_size=G, max_samples=16,
              max_steps=TM.CHECK_EVERY + 3)
    ref = JM.march_rays(*_j(o, d, nr, fr, bits), **kw)
    got = TM.march_rays(*_t(o, d, nr, fr, bits), **kw)
    assert got["iters"] == kw["max_steps"]
    _check(got, ref)


@pytest.mark.parametrize("case", ["bitfield", "skip_paired"])
def test_march_generic_rays_agree_up_to_fma(occupancy, case):
    """Normalised random directions. XLA on the CPU contracts o + t * d
    and cell * bound - pos into FMAs; PyTorch rounds each product. The
    march jumps to cell boundaries exactly, so one rounding there can send
    a ray into the neighbouring cell and its path apart (with both
    expressions rounded once, as an FMA does, the port matched JAX on
    every ray of these inputs). Measured on 1,024 rays and three seeds:
    counts equal on 86-94% of the rays, total samples within 1.6%."""
    bits, skip = occupancy
    c = CASES[case]
    o, d, nr, fr = _rays(n=1024, seed=0, exact=False)
    kw = dict(bound=1.0, cascade=1, grid_size=G, max_samples=16,
              max_steps=128, dt_gamma=c["dt_gamma"],
              samples_per_hit=c["samples_per_hit"])
    ref = JM.march_rays(*_j(o, d, nr, fr, bits),
                        skip_grid=jnp.asarray(skip) if c["skip"] else None,
                        **kw)
    got = TM.march_rays(*_t(o, d, nr, fr, bits),
                        skip_grid=torch.from_numpy(skip) if c["skip"]
                        else None, **kw)
    cj, ct = np.asarray(ref["count"]), got["count"].numpy()
    assert (cj == ct).mean() >= 0.8
    assert abs(int(ct.sum()) - int(cj.sum())) <= 0.03 * cj.sum()


def test_composite_marched_matches_jax():
    rng = np.random.default_rng(4)
    n, k = 200, 12
    sig = rng.uniform(0, 30, (n, k)).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, k, 3)).astype(np.float32)
    dts = rng.uniform(0.005, 0.03, (n, k)).astype(np.float32)
    ts = np.cumsum(dts, axis=1).astype(np.float32) + 1.0
    rs = np.diff(np.concatenate([np.ones((n, 1)), ts + dts], 1),
                 axis=1).astype(np.float32)
    mask = np.arange(k)[None] < rng.integers(0, k + 1, n)[:, None]
    nr, fr = np.full(n, 1.0, np.float32), np.full(n, 3.0, np.float32)
    args = (sig, rgb, dts * mask, rs * mask, ts, mask, nr, fr)
    ref = JM.composite_marched(*_j(*args), density_scale=1.5)
    got = TM.composite_marched(*_t(*args), density_scale=1.5)
    for key in ("weights", "weights_sum", "depth", "image",
                "aggregated_density", "depth_abs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_packbits_exact():
    grid = _grid(cascade=2, seed=5)
    for thresh in (0.0, 8.0, 12.5):
        np.testing.assert_array_equal(
            TR.packbits(torch.from_numpy(grid), thresh).numpy(),
            np.asarray(JR.packbits(jnp.asarray(grid), thresh)))


def test_occupancy_to_skip_grid_exact():
    occ = _grid(cascade=2, seed=6) > 10.0
    got = TR.occupancy_to_skip_grid(torch.from_numpy(occ), G)
    ref = JR.occupancy_to_skip_grid(jnp.asarray(occ), G)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert {0, 1, 2, 3} <= set(np.unique(got.numpy()).tolist())


def test_bitfield_lookup_exact(occupancy):
    bits, _ = occupancy
    idx = np.random.default_rng(7).integers(0, G ** 3, 5000)
    got = TR.bitfield_lookup(torch.from_numpy(bits), torch.from_numpy(idx))
    ref = JR.bitfield_lookup(jnp.asarray(bits), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
