"""Shared set-up of the sequential path's CPU parity tests
(test_torch_estimator.py, test_torch_uq_gaussian.py,
test_torch_sequential.py): one 2-level float32 hash-grid `NeRFNetwork`
from seeded numpy weights in both packages (carried across with
`params_from_jax`), unfused, and each package's closures over it, as the
validate CLI builds them: rays of a 16x16 camera, the staged frame
(`render_fn`, 64-ray chunks), the one-call render the estimator
differentiates (`render_batch_fn`), 16 samples a ray, and the planner's
density (scaled down, so that A* sees free space)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.data.rays import get_rays as j_get_rays
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.models.network import NeRFNetwork as JNet
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.data.rays import get_rays as t_get_rays
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.models import renderer as TR

RES = 16
STEPS = 16
CHUNK = 64
NET = dict(num_levels=2, desired_resolution=32, bound=1.0)
INTR = (20.0, 20.0, RES / 2, RES / 2)
ROT = np.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                 np.float32)
AGENT = {"mass": 1.0, "g": 10.0, "I": np.eye(3).tolist(), "dt": 1 / 6,
         "path": "sim_img_cache"}
CAMERA = {"res_x": RES, "res_y": RES, "trans": True, "mode": "RGBA",
          "path": "sim_img_cache", "half_res": False, "white_bg": True}
FILTER = {"dil_iter": 2, "kernel_size": 3, "batch_size": 64, "lrate": 1e-3,
          "N_iter": 4, "render_viz": False, "show_rate": [20, 100]}
# the start: at the seeded scene's edge, looking across it
START12 = np.float32([-0.6, 0.0, 0.1, 0, 0, 0, 0, 0, 0, 0, 0, 0])
HOVER = np.float32([10.0, 0.0, 0.0, 0.0])


def nets():
    """(JAX net, its params, the port's net)."""
    net_j = JNet(JConfig(**NET))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] = rng.uniform(
        -1, 1, p["encoder"]["embeddings"].shape).astype(np.float32)
    net_t = make_network(TConfig(**NET), params_from_jax(p, device="cpu"),
                         device="cpu")
    return net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


def jax_fns(net, p):
    """get_rays_fn, render_fn (staged), render_batch_fn, density_fn."""
    rot = jnp.asarray(ROT)
    return dict(
        get_rays_fn=lambda pose: j_get_rays(pose, INTR, RES, RES),
        render_fn=lambda o, d: JR.render(
            net, p, o, d, staged=True, bg_color=1.0, num_steps=STEPS,
            upsample_steps=0, max_ray_batch=CHUNK),
        render_batch_fn=lambda o, d: JR.render(
            net, p, o, d, staged=False, bg_color=1.0, num_steps=STEPS,
            upsample_steps=0),
        density_fn=lambda x: 1e-3 * net.density(
            p, x.reshape((-1, 3)) @ rot)["sigma"].reshape(x.shape[:-1]))


def port_fns(net):
    rot = torch.from_numpy(ROT)
    return dict(
        get_rays_fn=lambda pose: t_get_rays(pose, INTR, RES, RES,
                                            device="cpu"),
        render_fn=lambda o, d: TR.render(
            net, o, d, staged=True, bg_color=1.0, num_steps=STEPS,
            upsample_steps=0, max_ray_batch=CHUNK),
        render_batch_fn=lambda o, d: TR.render(
            net, o, d, staged=False, bg_color=1.0, num_steps=STEPS,
            upsample_steps=0),
        density_fn=lambda x: 1e-3 * net.density(
            x.reshape(-1, 3) @ rot)["sigma"].reshape(x.shape[:-1]))
