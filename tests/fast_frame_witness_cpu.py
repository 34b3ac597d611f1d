"""validate --fast_render's observation frame, like for like: pose 0 of the
spheres scene rendered through `render_grid_staged` in the JAX package and
in the port, both on the CPU, from bench_assets/refbb.ckpt (the CLI's
default float32 `NeRFNetwork`), and held against the analytic ground
truth, beside the staged 64-sample frame and two variants of the port's
fast frame that attribute its PSNR: the corner layout instead of the cell
layout, and no sample budget (every marched sample shaded).

    PYTHONPATH=. python tests/fast_frame_witness_cpu.py [--res 100]

The occupancy grid is the CLI's: one `update_extra_state` of an empty
state (the port's, from a generator seeded 0; the JAX frame gets the
port's bitfield and skip grid). The fast frame's settings are the CLI's
defaults: chunks of 4,096 rays, 32 samples a ray at most, a budget of 12
samples a ray a chunk, 1,024 march steps, dt_gamma 1/128. Prints each
PSNR, the grid's occupied share, and the marched samples a ray. A few
minutes (the 128^3 refresh, JAX's compile)."""

import argparse
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu_torch import flagship as F
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.data.synthetic import (camera_rays,
                                                           trace_scene)
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.ops.marching import march_rays
from nerfsafetyvalidation_tpu_torch.ops.ray_ops import near_far_from_aabb

CFG = dict(encoding="hashgrid", bound=1.0, compute_dtype="float32",
           density_thresh=10.0, fused=False)
FAST = dict(max_ray_batch=4096, max_steps=1024, dt_gamma=1.0 / 128,
            bg_color=1.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=100)
    res = ap.parse_args().res
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(8)
    with open(F.REF_CKPT, "rb") as f:
        model = pickle.load(f)["model"]
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32)
        if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a), model)
    net_j = j_make(JConfig(**CFG))
    p_j = jax.tree_util.tree_map(jnp.asarray, p)
    net = t_make(TConfig(**CFG), params_from_jax(p, device="cpu"),
                 device="cpu")

    pose = F.holdout_poses()[0]
    o_np, d_np = camera_rays(pose, F.intrinsics(res), res, res)
    rgb, alpha, _ = trace_scene(o_np, d_np, scene="spheres")
    gt = (rgb * alpha[..., None] + (1.0 - alpha[..., None])).reshape(-1, 3)
    o, d = F.pose_rays(pose, "cpu", res)

    def psnr(img):
        img = np.asarray(img, dtype=np.float64).reshape(-1, 3)
        return float(-10.0 * np.log10(np.mean((img - gt) ** 2)))

    with torch.no_grad():
        t0 = time.perf_counter()
        state = TR.update_extra_state(
            net, TR.RendererState.create(1, 128, device="cpu"),
            generator=torch.Generator().manual_seed(0), grid_size=128)
        view = net.to_cell()
        print(f"refresh and to_cell {time.perf_counter() - t0:.1f} s; grid "
              f"occupied {np.unpackbits(state.density_bitfield.numpy()).mean():.4f}"
              f", mean density {float(state.mean_density):.3f}")
        frames = {
            "port fast (cell layout)": TR.render_grid_staged(
                view, state, o[None], d[None], **FAST)["image"],
            "port fast, corner layout": TR.render_grid_staged(
                net, state, o[None], d[None], **FAST)["image"],
            "port fast, no sample budget": TR.run_grid(
                view, state, o, d, max_samples=32, max_steps=1024,
                dt_gamma=1.0 / 128, bg_color=1.0)["image"],
            "port staged, 64 samples": TR.render(
                net, o[None], d[None], staged=True, bg_color=1.0,
                num_steps=64, max_ray_batch=4096)["image"]}
        nears, fars = near_far_from_aabb(o, d, TR.aabb_of(net.cfg, "cpu"),
                                         net.cfg.min_near)
        m = march_rays(o, d, nears, fars, state.density_bitfield, 1.0, 1,
                       128, max_samples=32, max_steps=1024,
                       dt_gamma=1.0 / 128, skip_grid=state.skip_grid)
        count = m["mask"].sum(1).float()
    s_j = JR.RendererState(
        jnp.asarray(state.density_grid.numpy()),
        jnp.asarray(state.density_bitfield.numpy()),
        jnp.asarray(float(state.mean_density)), jnp.asarray(1),
        jnp.asarray(state.skip_grid.numpy()))
    t0 = time.perf_counter()
    frames["JAX fast (cell layout)"] = JR.render_grid_staged(
        net_j, net_j.to_cell(p_j), s_j, jnp.asarray(o.numpy())[None],
        jnp.asarray(d.numpy())[None], **FAST)["image"]
    print(f"JAX frame {time.perf_counter() - t0:.1f} s (compile included)")
    for name, img in frames.items():
        print(f"{name}: PSNR {psnr(img):.3f} dB")
    a = np.asarray(frames["JAX fast (cell layout)"]).reshape(-1, 3)
    b = frames["port fast (cell layout)"].numpy().reshape(-1, 3)
    print(f"JAX vs port fast frames: max {np.abs(a - b).max():.3e}, mean "
          f"{np.abs(a - b).mean():.3e}")
    print(f"marched samples a ray: mean {float(count.mean()):.2f}, max "
          f"{int(count.max())}; rays with more than 12: "
          f"{float((count > 12).float().mean()):.4f}")


if __name__ == "__main__":
    main()
