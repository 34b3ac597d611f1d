"""PyTorch port vs JAX package: encodings, ray ops, mip helpers, rays and
the analytic scene. Inputs are made with numpy and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.data import rays as j_rays
from nerfsafetyvalidation_tpu.data import synthetic as j_syn
from nerfsafetyvalidation_tpu.ops import activation as j_act
from nerfsafetyvalidation_tpu.ops import freq_encoding as j_freq
from nerfsafetyvalidation_tpu.ops import marching as j_march
from nerfsafetyvalidation_tpu.ops import ray_ops as j_ray
from nerfsafetyvalidation_tpu.ops import sh_encoding as j_sh
from nerfsafetyvalidation_tpu_torch.data import rays as t_rays
from nerfsafetyvalidation_tpu_torch.data import synthetic as t_syn
from nerfsafetyvalidation_tpu_torch.ops import activation as t_act
from nerfsafetyvalidation_tpu_torch.ops import freq_encoding as t_freq
from nerfsafetyvalidation_tpu_torch.ops import marching as t_march
from nerfsafetyvalidation_tpu_torch.ops import ray_ops as t_ray
from nerfsafetyvalidation_tpu_torch.ops import sh_encoding as t_sh

# torch's CPU sin/cos go through MKL VML, which splits an array over its
# own threads; under a loaded machine the second thread's share came back
# accurate to only ~1.5e-4 in a few runs of a hundred (JAX and the first
# share stay exact to float32). One thread keeps the CPU reference exact.
torch.set_num_threads(1)


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("degree", [4, 12])
def test_freq_encode(degree):
    x = np.random.default_rng(0).uniform(-1, 1, (513, 3)).astype(np.float32)
    got = t_freq.freq_encode(torch.from_numpy(x), degree).numpy()
    want = np.asarray(j_freq.freq_encode(jnp.asarray(x), degree))
    assert got.shape == want.shape == (513, t_freq.freq_output_dim(3, degree))
    # sin/cos of arguments up to 2^11 rad: the two libraries' f32 range
    # reductions agree to a few ulp of the argument
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(degree):
    d = _unit(np.random.default_rng(1), 400)
    got = t_sh.sh_encode(torch.from_numpy(d), degree).numpy()
    want = np.asarray(j_sh.sh_encode(jnp.asarray(d), degree))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_near_far_from_aabb():
    rng = np.random.default_rng(2)
    o = rng.uniform(-3, 3, (600, 3)).astype(np.float32)
    d = _unit(rng, 600)
    aabb = np.asarray([-1, -1, -1, 1, 1, 1], np.float32)
    n_t, f_t = t_ray.near_far_from_aabb(torch.from_numpy(o),
                                        torch.from_numpy(d),
                                        torch.from_numpy(aabb), 0.2)
    n_j, f_j = j_ray.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(aabb), 0.2)
    n_j, f_j = np.asarray(n_j), np.asarray(f_j)
    miss = n_j == np.finfo(np.float32).max
    assert 0 < miss.sum() < miss.size
    np.testing.assert_allclose(n_t.numpy(), n_j, rtol=1e-6, atol=0)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("hi", [128, 1024])
def test_morton3d_and_invert(hi):
    c = np.random.default_rng(3).integers(0, hi, (1000, 3)).astype(np.int32)
    got = t_ray.morton3d(torch.from_numpy(c)).numpy()
    want = np.asarray(j_ray.morton3d(jnp.asarray(c)))
    np.testing.assert_array_equal(got, want)
    back = t_ray.morton3d_invert(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back, c)
    np.testing.assert_array_equal(
        back, np.asarray(j_ray.morton3d_invert(jnp.asarray(want))))


@pytest.mark.parametrize("cascade", [1, 3])
def test_mip_helpers(cascade):
    rng = np.random.default_rng(4)
    pos = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
    dt = rng.uniform(0, 0.2, (700, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        t_march._mip_from_pos(torch.from_numpy(pos), cascade).numpy(),
        np.asarray(j_march._mip_from_pos(jnp.asarray(pos), cascade)))
    np.testing.assert_array_equal(
        t_march._mip_from_dt(torch.from_numpy(dt), 128, cascade).numpy(),
        np.asarray(j_march._mip_from_dt(jnp.asarray(dt), 128, cascade)))


def test_trunc_exp_value_and_clamped_gradient():
    x = np.asarray([-30.0, -2.0, 0.0, 3.0, 20.0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_act.trunc_exp(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(j_act.trunc_exp(jnp.asarray(x))),
                               rtol=1e-6)
    g_j = jax.grad(lambda v: jnp.sum(j_act.trunc_exp(v)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=1e-6)


def test_get_rays_and_pose_convention():
    pose = j_syn.orbit_pose(0.77, 0.52, 2.4)
    ngp_t = t_rays.nerf_matrix_to_ngp(pose, scale=1.0)
    ngp_j = j_rays.nerf_matrix_to_ngp(pose, scale=1.0)
    np.testing.assert_array_equal(ngp_t, ngp_j)
    H, W = 12, 16
    fx = 0.5 * W / np.tan(0.5 * 0.6911)
    intr = (fx, fx, W / 2, H / 2)
    got = t_rays.get_rays(ngp_t[None], intr, H, W, device="cpu")
    want = j_rays.get_rays(jnp.asarray(ngp_j[None]), intr, H, W)
    for k in ("rays_o", "rays_d"):
        assert got[k].shape == (1, H * W, 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)


def test_synthetic_scene_copy():
    for th, ph in [(0.77, 0.52), (3.85, 0.65)]:
        np.testing.assert_array_equal(t_syn.orbit_pose(th, ph, 2.4),
                                      j_syn.orbit_pose(th, ph, 2.4))
    pose = j_syn.orbit_pose(2.31, 0.30, 2.4)
    intr = (40.0, 40.0, 16.0, 12.0)
    o_t, d_t = t_syn.camera_rays(pose, intr, 24, 32)
    o_j, d_j = j_syn.camera_rays(pose, intr, 24, 32)
    np.testing.assert_array_equal(d_t, d_j)
    for scene in ("spheres", "gauntlet"):
        for a, b in zip(t_syn.trace_scene(o_t, d_t, scene),
                        j_syn.trace_scene(o_j, d_j, scene)):
            np.testing.assert_array_equal(a, b)
