"""The port's analytic ground truth (nerfsafetyvalidation_tpu_torch/data/
synthetic.py) against the JAX package's, on the CPU: `trace_gauntlet`
with its helpers `_ray_box` and `_ray_cyl_z`, and `trace_scene` for both
scenes. Both are float64 numpy of the same expressions, so the tolerance
is none: every output is bit-equal."""

import numpy as np
import pytest

from nerfsafetyvalidation_tpu.data import synthetic as JS
from nerfsafetyvalidation_tpu_torch.data import synthetic as TS


def _orbit_rays(seed, res=40):
    """Camera rays of a seeded orbit pose over the scene, as bench.py's
    held-out views are made, at `res`^2."""
    rng = np.random.default_rng(seed)
    pose = JS.orbit_pose(rng.uniform(0, 2 * np.pi), rng.uniform(0.1, 0.9),
                         rng.uniform(1.8, 3.0))
    fx = 0.5 * res / np.tan(0.5 * 0.6911)
    return JS.camera_rays(pose, (fx, fx, res / 2, res / 2), res, res)


def _random_rays(seed, n=5000):
    """Rays from seeded points in and around the box in seeded
    directions, some of them axis-aligned (the tracers' guarded
    divisions)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3))
    d = rng.normal(size=(n, 3))
    axis = rng.integers(0, 3, n // 5)
    d[: n // 5] = 0.0
    d[np.arange(n // 5), axis] = rng.choice([-1.0, 1.0], n // 5)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_trace_gauntlet_matches_jax_on_camera_rays(seed):
    o, d = _orbit_rays(seed)
    got = TS.trace_gauntlet(o, d)
    _equal(got, JS.trace_gauntlet(o, d))
    alpha = got[1]
    assert 0 < alpha.sum() < alpha.size      # hits and misses both


@pytest.mark.parametrize("seed", range(3))
def test_trace_gauntlet_matches_jax_on_random_rays(seed):
    o, d = _random_rays(seed)
    _equal(TS.trace_gauntlet(o, d), JS.trace_gauntlet(o, d))


@pytest.mark.parametrize("seed", range(2))
def test_ray_helpers_match_jax(seed):
    o, d = _random_rays(10 + seed)
    for xmin, xmax, ymin, ymax, zmin, zmax, _, _ in JS.SLABS:
        lo = np.asarray([xmin, ymin, zmin])
        hi = np.asarray([xmax, ymax, zmax])
        _equal(TS._ray_box(o, d, lo, hi), JS._ray_box(o, d, lo, hi))
    for cx, cy, r, z1, _ in JS.PILLARS:
        _equal(TS._ray_cyl_z(o, d, cx, cy, r, JS.PILLAR_Z0, z1),
               JS._ray_cyl_z(o, d, cx, cy, r, JS.PILLAR_Z0, z1))


@pytest.mark.parametrize("scene", ["spheres", "gauntlet"])
def test_trace_scene_dispatch_matches_jax(scene):
    o, d = _orbit_rays(7)
    _equal(TS.trace_scene(o, d, scene=scene),
           JS.trace_scene(o, d, scene=scene))


def test_gauntlet_views_match_jax():
    """`scene_views` of the gauntlet (the training views bench.py's
    gauntlet teacher saw): images and poses bit-equal."""
    got = TS.scene_views(3, 24, 24, seed=5, scene="gauntlet")
    want = JS.scene_views(3, 24, 24, seed=5, scene="gauntlet")
    _equal(got[:2], want[:2])
    assert got[2] == want[2]
