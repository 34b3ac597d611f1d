"""The reference-backbone slice end to end, port vs JAX on the CPU.

* bench_assets/refbb.ckpt through the port's loader equals bench.py's
  bf16 -> f32 upcast of it, bit for bit, and `flagship`'s ref
  configuration is bench.py's (bench.py:371-373, :810-835);
* a small hash-grid net (6 levels of 2 channels from 4 to 64, 2^10 rows)
  with random weights drawn by numpy from a seed, fused (K4) and unfused:
  - `update_extra_state` twice from an empty grid with the JAX package's
    own jitter draws handed to the port: bitfield and skip grid equal, the
    density grid close;
  - `render_frame_fast` at 48x48 from an occupancy grid that holds a ball,
    with an orthographic camera whose direction components are 0 or powers
    of two, so that the march is exact in both packages (XLA on the CPU
    contracts o + t * d into an FMA, PyTorch does not; see
    tests/test_torch_marching.py)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.ops import ray_ops as JO
from nerfsafetyvalidation_tpu_torch import flagship as F
from nerfsafetyvalidation_tpu_torch.assets import (load_checkpoint,
                                                   params_from_jax)
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as K4

torch.set_num_threads(1)

G = 32
RES = 48
NET = dict(encoding="hashgrid", bound=1.0, num_levels=6, level_dim=2,
           base_resolution=4, log2_hashmap_size=10, desired_resolution=64,
           grid_size=G, density_thresh=20.0)


def test_refbb_loads_bit_exact():
    """Every array of the checkpoint, model and renderer state, equals
    bench.py's upcast (ml_dtypes bfloat16 -> float32 through plain
    pickle)."""
    params, state = load_checkpoint(F.REF_CKPT, device="cpu")
    with open(F.REF_CKPT, "rb") as f:
        ref = pickle.load(f)

    def up(a):                          # bench.py _upcast_asset
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    m = ref["model"]
    pairs = [(params["encoder"]["embeddings"], m["encoder"]["embeddings"])]
    pairs += list(zip(params["sigma_net"], m["sigma_net"]))
    pairs += list(zip(params["color_net"], m["color_net"]))
    rs = ref["renderer_state"]
    pairs += [(getattr(state, k), getattr(rs, k))
              for k in ("density_grid", "density_bitfield", "mean_density",
                        "iter_density", "skip_grid")]
    for got, want in pairs:
        want = up(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(),
                                      want.astype(got.numpy().dtype))
    assert [tuple(w.shape) for w in params["sigma_net"]] == [(32, 64),
                                                             (64, 16)]
    assert tuple(params["encoder"]["embeddings"].shape) == (6119864, 2)


def test_ref_config_is_bench_py_s():
    """REF_CFG is bench.py's config with fused=True; its grid equals the
    JAX NeRFNetwork's, with and without the level mask; the two modes are
    bench.py's marched frame settings."""
    from dataclasses import replace

    from nerfsafetyvalidation_tpu.models.network import NeRFNetwork as JNet
    from nerfsafetyvalidation_tpu_torch.models.network import grid_spec_of
    cfg_j = JConfig(encoding="hashgrid", bound=1.0, compute_dtype="bfloat16",
                    grid_ray=True, density_thresh=10.0)
    for k in ("encoding", "bound", "compute_dtype", "density_thresh",
              "num_levels", "level_dim", "base_resolution",
              "log2_hashmap_size", "grid_resolution", "align_corners",
              "aligned_levels", "num_layers", "hidden_dim",
              "num_layers_color", "hidden_dim_color", "geo_feat_dim",
              "sh_degree", "grid_size", "min_near", "density_scale",
              "bg_radius", "max_level", "cascade"):
        assert getattr(F.REF_CFG, k) == getattr(cfg_j, k), k
    assert F.REF_CFG.fused
    for ml in (None, F.REF_MAX_LEVEL):
        s_t = grid_spec_of(replace(F.REF_CFG, max_level=ml))
        s_j = JNet(replace(cfg_j, max_level=ml)).grid_spec
        assert vars(s_t) == vars(s_j)
    for mode in ("ref_backbone", "ref_backbone_ml8"):
        m = F.MODES[mode]
        assert m["kernel"] == "K4" and mode in F.MARCHED
        assert m["frame"] == dict(tile=131072, max_samples=16, max_steps=512,
                                  dt_gamma=1.0 / 64, bg_color=1.0)
    assert F.REF_MAX_LEVEL == 8


def _params(net_j, seed=3):
    """The JAX pytree's shapes, filled by numpy; the table scaled up and
    sigma's output lane made positive, so that the densities are of order
    1-100 and vary in space."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] *= 3.0
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


@pytest.fixture(scope="module",
                params=[("bfloat16", True), ("bfloat16", False),
                        ("float32", True)])
def grid_net(request):
    dtype, fused = request.param
    cfg = dict(NET, compute_dtype=dtype, fused=fused)
    net_j = j_make(JConfig(**cfg))
    p = _params(net_j)
    net_t = t_make(TConfig(**cfg), params_from_jax(p, device="cpu"),
                   device="cpu")
    return dtype, net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


@pytest.fixture(scope="module")
def refreshed(grid_net):
    """Two refreshes from an empty grid in each package."""
    _, net_j, p_j, net_t = grid_net
    s_j = JR.RendererState.create(1, G)
    s_t = _state_t(s_j)
    for seed in (100, 101):
        s_j = JR.update_extra_state(net_j, p_j, s_j,
                                    jax.random.PRNGKey(seed), grid_size=G)
        s_t = TR.update_extra_state(
            net_t, s_t, jitter=[torch.from_numpy(_jitter(seed).copy())],
            grid_size=G)
    return s_j, s_t


def test_update_extra_state_matches_jax(grid_net, refreshed):
    dtype = grid_net[0]
    s_j, s_t = refreshed
    grid_j = np.asarray(s_j.density_grid)
    # f32: the jittered probe points come out of an FMA in XLA, so the
    # densities may differ in the last bits (measured 1.1e-6 relative on
    # the mip-fold teacher, test_torch_teacher_frame.py). bf16: one hidden
    # activation on the neighbouring bf16 value moves sigma's f32
    # pre-activation (unfused); measured 4.5e-5 relative in 1 of 32,768
    # cells, bounded at one bf16 step, 2^-8
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(s_t.density_grid.numpy(), grid_j,
                               rtol=rtol, atol=1e-6)
    occ = (grid_j > NET["density_thresh"]).mean()
    assert 0.05 < occ < 0.95, occ                   # a carved grid
    np.testing.assert_array_equal(s_t.density_bitfield.numpy(),
                                  np.asarray(s_j.density_bitfield))
    np.testing.assert_array_equal(s_t.skip_grid.numpy(),
                                  np.asarray(s_j.skip_grid))
    assert int(s_t.iter_density) == int(s_j.iter_density) == 2


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


FAST = dict(tile=512, max_samples=16, max_steps=64, dt_gamma=1.0 / 64,
            bg_color=1.0)


def _check(got, want, key, dtype):
    """f32: the same operations in other sum orders (measured 6.5e-6 of
    max(|value|, 1) at most), bounded at 1e-4 as the teacher frame is
    (test_torch_teacher_frame.py). bf16: where the sum order lands an
    activation on the neighbouring bf16 value, the field moves by a
    fraction of a bf16 step and the march composites it; measured, of
    max(|value|, 1), at most 0.033 (aggregated density, densities up to
    230) and 0.013 (image), 8.3e-4 and 1.4e-4 on average. Bounded at about
    4x the largest maximum and 5-7x the means."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=key)
        return
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    mean_bound = 5e-3 if key == "aggregated_density" else 1e-3
    assert err.max() <= 0.05 and err.mean() <= mean_bound, \
        (key, err.max(), err.mean())


def test_render_frame_fast_matches_jax(grid_net, ball):
    dtype, net_j, p_j, net_t = grid_net
    s_j, s_t = ball
    o, d = _ortho_rays()
    JR._FRAME_FAST_CACHE.clear()
    ref = JR.render_frame_fast(net_j, p_j, s_j, jnp.asarray(o),
                               jnp.asarray(d), **FAST)
    before = K4.LAUNCHES
    got = TR.render_frame_fast(net_t, s_t, torch.from_numpy(o),
                               torch.from_numpy(d), **FAST)
    assert K4.LAUNCHES == before        # CPU tensors: the plain version
    ws = np.asarray(ref["weights_sum"])
    assert (ws > 0.5).mean() > 0.2 and (ws < 0.01).mean() > 0.05
    assert 0 in got["tile_bucket"] and got["tile_bucket"].max() >= 2
    for k in ("image", "depth", "aggregated_density", "weights_sum",
              "depth_abs"):
        _check(got[k].numpy(), np.asarray(ref[k]), k, dtype)
