"""The teacher slice end to end, port vs JAX on the CPU, at a small mip
spec (5 levels of 2 channels from base 4, dense to 16, 2^10 hash rows) and
a 32^3 occupancy grid, with random weights drawn by numpy from a seed:

  * `update_extra_state` twice from an empty grid, with the JAX package's
    own jitter draws handed to the port: the bitfield and the skip grid
    must be equal, the density grid close;
  * `render_frame_fast` and `render_frame_guided(prepass_mode="march")` at
    48x48, from an occupancy grid that holds a ball of radius 0.45 (a
    refresh of a random field occupies cells everywhere, and the frames
    need sky to skip).

The frames use an orthographic camera whose direction components are 0 or
powers of two, so every product t * d is exact and the march takes the
same path in both packages (XLA on the CPU contracts o + t * d into an FMA,
PyTorch does not; see tests/test_torch_marching.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.ops import ray_ops as JO
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.ops.hopper import sigma_color as sc

torch.set_num_threads(1)

G = 32
RES = 48
NET = dict(encoding="mipfold", bound=1.0, num_levels=5, level_dim=2,
           base_resolution=4, fold_max_scale=16, log2_hashmap_size=10,
           grid_size=G, density_thresh=3.0)


def _params(net_j, seed=3):
    """The JAX pytree's shapes, filled by numpy; the sigma output's lane 0
    made positive, so that the densities are of order 1-10."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["sigma_net"][-1][:, 0] = np.abs(p["sigma_net"][-1][:, 0])
    return p


def _jitter(seed):
    """The draws JAX's update_extra_state makes from PRNGKey(seed)."""
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    return np.array(jax.random.uniform(sub, (G ** 3, 3)))


def _state_t(s):
    return TR.RendererState(
        density_bitfield=torch.from_numpy(np.array(s.density_bitfield)),
        density_grid=torch.from_numpy(np.array(s.density_grid)),
        mean_density=torch.from_numpy(np.array(s.mean_density)),
        iter_density=torch.from_numpy(np.array(s.iter_density)),
        skip_grid=None if s.skip_grid is None
        else torch.from_numpy(np.array(s.skip_grid)))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def teacher(request):
    cfg_j = JConfig(**NET, compute_dtype=request.param)
    net_j = j_make(cfg_j)
    p = _params(net_j)
    fp_j = net_j.to_folded(jax.tree_util.tree_map(jnp.asarray, p))
    net_t = t_make(TConfig(**NET, compute_dtype=request.param),
                   params_from_jax(p, device="cpu"), device="cpu")
    return request.param, net_j, fp_j, net_t.to_folded()


@pytest.fixture(scope="module")
def refreshed(teacher):
    """Two refreshes from an empty grid in each package."""
    _, net_j, fp_j, net_t = teacher
    s_j = JR.RendererState.create(1, G)
    s_t = _state_t(s_j)
    for seed in (100, 101):
        s_j = JR.update_extra_state(net_j, fp_j, s_j,
                                    jax.random.PRNGKey(seed), grid_size=G)
        s_t = TR.update_extra_state(
            net_t, s_t, jitter=[torch.from_numpy(_jitter(seed).copy())],
            grid_size=G)
    return s_j, s_t


def test_update_extra_state_matches_jax(teacher, refreshed):
    dtype = teacher[0]
    s_j, s_t = refreshed
    grid_j = np.asarray(s_j.density_grid)
    # the jittered probe points come out of an FMA in XLA, so the
    # densities may differ in the last bits; measured 1.1e-6 relative
    np.testing.assert_allclose(s_t.density_grid.numpy(), grid_j,
                               rtol=1e-5, atol=1e-6)
    assert float(s_j.mean_density) > NET["density_thresh"]
    occ = (grid_j > NET["density_thresh"]).mean()
    assert 0.1 < occ < 0.9, occ                     # a carved grid
    np.testing.assert_array_equal(s_t.density_bitfield.numpy(),
                                  np.asarray(s_j.density_bitfield))
    np.testing.assert_array_equal(s_t.skip_grid.numpy(),
                                  np.asarray(s_j.skip_grid))
    assert int(s_t.iter_density) == int(s_j.iter_density) == 2
    np.testing.assert_allclose(float(s_t.mean_density),
                               float(s_j.mean_density), rtol=1e-5)


def test_update_extra_state_draws_from_a_generator(teacher, refreshed):
    """Without handed-in jitter the draws come from the generator: two
    generators with one seed give one state."""
    net_t = teacher[3]
    _, s_t = refreshed
    a, b = (TR.update_extra_state(
        net_t, s_t, generator=torch.Generator().manual_seed(7),
        grid_size=G) for _ in range(2))
    assert torch.equal(a.density_bitfield, b.density_bitfield)
    assert torch.equal(a.density_grid, b.density_grid)


@pytest.fixture(scope="module")
def ball():
    """A state whose occupied cells are a ball of radius 0.45, in both
    packages (bitfield and skip grid built by JAX)."""
    g = np.arange(G)
    ijk = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    c = 2.0 * (ijk + 0.5) / G - 1.0
    grid = np.zeros((1, G ** 3), np.float32)
    code = np.asarray(JO.morton3d(jnp.asarray(ijk)))
    grid[0, code] = np.where(np.linalg.norm(c, axis=-1) < 0.45, 20.0, 0.0)
    gj = jnp.asarray(grid)
    s_j = JR.RendererState(gj, JO.packbits(gj, 10.0), jnp.asarray(20.0),
                           jnp.asarray(1),
                           JO.occupancy_to_skip_grid(gj > 10.0, G))
    return s_j, _state_t(s_j)


def _ortho_rays():
    """48x48 orthographic rays from z = -2.5, direction (2^-4, -2^-3, 1)."""
    c = (np.arange(RES) + 0.5) / RES * 1.6 - 0.8
    yy, xx = np.meshgrid(c, c, indexing="ij")
    o = np.stack([xx.ravel(), yy.ravel(), np.full(RES * RES, -2.5)],
                 -1).astype(np.float32)
    d = np.broadcast_to(np.float32([0.0625, -0.125, 1.0]), o.shape).copy()
    return o, d


def _tol(dtype, key):
    """f32: measured 2.4e-6 at most (image), bounded at 1e-4. bf16: the
    two frameworks round bf16 intermediates of the encode and the MLP at
    different points, and a feature one bf16 step away moves the field;
    measured image 2.8e-3, opacity 1.0e-3, depth_abs 2.4e-3 and
    aggregated density 0.10 (of values up to 10.5), bounded at about 4x."""
    if dtype == "float32":
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=0, atol=0.5 if key == "aggregated_density" else 1e-2)


FAST = dict(tile=512, max_samples=16, max_steps=64, dt_gamma=1.0 / 64,
            bg_color=1.0)


def test_render_frame_fast_matches_jax(teacher, ball):
    dtype, net_j, fp_j, net_t = teacher
    s_j, s_t = ball
    o, d = _ortho_rays()
    JR._FRAME_FAST_CACHE.clear()
    ref = JR.render_frame_fast(net_j, fp_j, s_j, jnp.asarray(o),
                               jnp.asarray(d), **FAST)
    got = TR.render_frame_fast(net_t, s_t, torch.from_numpy(o),
                               torch.from_numpy(d), **FAST)
    ws = np.asarray(ref["weights_sum"])
    assert (ws > 0.5).mean() > 0.2 and (ws < 0.01).mean() > 0.05
    assert 0 in got["tile_bucket"] and got["tile_bucket"].max() >= 2
    for k in ("image", "depth", "aggregated_density", "weights_sum",
              "depth_abs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **_tol(dtype, k))


GUIDED = dict(prepass_factor=8, max_samples=16, tile=512, max_steps=64,
              dt_gamma=1.0 / 64, bg_color=1.0, margin_cells=6.0,
              prepass_mode="march")


def test_render_frame_guided_march_matches_jax(teacher, ball):
    dtype, net_j, fp_j, net_t = teacher
    s_j, s_t = ball
    o, d = _ortho_rays()
    JR._FRAME_FAST_CACHE.clear()
    JR._FRAME_GUIDED_CACHE.clear()
    ref = JR.render_frame_guided(net_j, fp_j, s_j, jnp.asarray(o),
                                 jnp.asarray(d), RES, RES,
                                 natural_tile_cap=GUIDED["tile"], **GUIDED)
    before = sc.LAUNCHES
    got = TR.render_frame_guided(net_t, s_t, torch.from_numpy(o),
                                 torch.from_numpy(d), RES, RES, **GUIDED)
    assert sc.LAUNCHES == before        # CPU tensors: the plain version
    ws = np.asarray(ref["weights_sum"])
    assert (ws > 0.5).mean() > 0.2 and (ws < 0.01).mean() > 0.3
    for k in ("image", "depth", "aggregated_density", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **_tol(dtype, k))


def test_guided_prepass_net_places_the_windows(teacher, ball):
    """prepass_net marches the prepass through another field: with the
    same net it is the default frame, bit for bit."""
    net_t = teacher[3]
    _, s_t = ball
    o, d = (torch.from_numpy(a) for a in _ortho_rays())
    a = TR.render_frame_guided(net_t, s_t, o, d, RES, RES, **GUIDED)
    b = TR.render_frame_guided(net_t, s_t, o, d, RES, RES,
                               prepass_net=net_t, **GUIDED)
    assert torch.equal(a["image"], b["image"])
