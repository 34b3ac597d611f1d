"""The staged frame of the reference backbone, like for like: pose 0 of
the spheres scene rendered through the staged render in the JAX package
and in the port, both on the CPU, from bench_assets/refbb.ckpt, and each
frame held against the analytic ground truth and against the other.

    PYTHONPATH=. python tests/staged_frame_witness_cpu.py [--res 100]

The validate CLI's observation render: `render(staged=True)`, chunks of
4,096 rays, 512 uniform samples a ray, no upsampling, white background,
on the CLI's default float32 `NeRFNetwork` with refbb.ckpt's weights
(bench.py's bf16 -> f32 upcast), unfused in both packages (the same
function as K4's f32 kernel, which the chip smoke's `staged` mode runs;
the JAX package's fused kernel would run in interpret mode here). The
frame is 100^2 by default (the 800^2 camera's field of view). Prints the
two PSNRs against the truth, the packages' PSNR against each other, the
largest and mean pixel difference, and each frame's PSNR apart on the
rays that miss the scene's spheres (white in the truth) and on those
that hit them.
A few minutes."""

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

CFG = dict(encoding="hashgrid", bound=1.0, compute_dtype="float32",
           density_thresh=10.0, fused=False)
FRAME = dict(staged=True, max_ray_batch=4096, num_steps=512,
             upsample_steps=0, bg_color=1.0)


def psnr(a, b):
    return float(-10.0 * np.log10(max(np.mean((a - b) ** 2), 1e-10)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=100)
    res = ap.parse_args().res
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    with open(F.REF_CKPT, "rb") as f:
        model = pickle.load(f)["model"]
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32)
        if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a), model)
    net_j = j_make(JConfig(**CFG))
    p_j = jax.tree_util.tree_map(jnp.asarray, p)
    net_t = t_make(TConfig(**CFG), params_from_jax(p, device="cpu"),
                   device="cpu")

    pose = F.holdout_poses()[0]
    o_np, d_np = camera_rays(pose, F.intrinsics(res), res, res)
    rgb, alpha, _ = trace_scene(o_np, d_np, scene="spheres")
    gt = (rgb * alpha[..., None] + (1.0 - alpha[..., None])).reshape(-1, 3)
    o, d = F.pose_rays(pose, "cpu", res)

    t0 = time.perf_counter()
    out_j = JR.render(net_j, p_j, jnp.asarray(o.numpy())[None],
                      jnp.asarray(d.numpy())[None], **FRAME)
    img_j = np.asarray(out_j["image"][0], dtype=np.float64)
    t_j = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        out_t = TR.render(net_t, o[None], d[None], **FRAME)
    img_t = out_t["image"][0].numpy().astype(np.float64)
    t_t = time.perf_counter() - t0

    diff = np.abs(img_t - img_j)
    empty = alpha.reshape(-1) == 0
    print(f"pose 0 at {res}x{res}, staged, 512 samples a ray, refbb.ckpt "
          f"on the CLI's float32 NeRFNetwork (unfused), CPU")
    print(f"JAX package: PSNR vs truth {psnr(img_j, gt):.3f} dB "
          f"({t_j:.1f} s)")
    print(f"port:        PSNR vs truth {psnr(img_t, gt):.3f} dB "
          f"({t_t:.1f} s)")
    print(f"port vs JAX: PSNR {psnr(img_t, img_j):.3f} dB, max abs "
          f"{diff.max():.3e}, mean abs {diff.mean():.3e}")
    for name, img in (("JAX", img_j), ("port", img_t)):
        print(f"{name}: PSNR vs truth on the {int(empty.sum())} rays that "
              f"miss the spheres {psnr(img[empty], gt[empty]):.3f} dB, on "
              f"the {int((~empty).sum())} that hit them "
              f"{psnr(img[~empty], gt[~empty]):.3f} dB; mean rgb on the "
              f"misses {img[empty].mean():.4f} (the truth: 1)")


if __name__ == "__main__":
    main()
