"""Where the time of one baked-student guided frame goes on the card.

    python3 -m nerfsafetyvalidation_tpu_torch.profile_frame

Renders the first held-out spheres pose at 800x800 with bench.py's
baked_h160_ak8 settings (the frame `chip_smoke.py` checks), warms up, then
renders it once under `torch.profiler` and prints the device time by
kernel, the device time of K1, and the device's busy share of the frame's
wall time. Needs a CUDA card.
"""

import time
from collections import defaultdict
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from .assets import load_renderer_state, load_student, params_from_jax
from .config import NetworkConfig
from .data.rays import get_rays, nerf_matrix_to_ngp
from .data.synthetic import orbit_pose
from .models import make_network
from .models.bake import student_config
from .models.renderer import render_frame_guided

ROOT = Path(__file__).resolve().parents[1]
FRAME = dict(prepass_factor=8, scout_samples=64, max_samples=16, tile=8192,
             adaptive_k=8, adaptive_span_cells=24.0, bg_color=1.0,
             margin_cells=6.0)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = replace(student_config(
        NetworkConfig(bound=1.0, compute_dtype="bfloat16", grid_size=128),
        multires=12, hidden_dim=160, num_layers=6), fused=True)
    net = make_network(cfg, params_from_jax(load_student(
        ROOT / "bench_assets" / "bench_student_h160x6.pkl"), dev), dev)
    state = load_renderer_state(ROOT / "bench_assets" / "flagship.ckpt", dev)
    res = 800
    fx = 0.5 * res / np.tan(0.5 * 0.6911)
    pose = nerf_matrix_to_ngp(orbit_pose(0.77, 0.52, 2.4), scale=1.0)
    rays = get_rays(pose[None], (fx, fx, res / 2, res / 2), res, res, dev)
    o, d = rays["rays_o"][0].contiguous(), rays["rays_d"][0].contiguous()

    def frame():
        return render_frame_guided(net, state, o, d, res, res, **FRAME)

    with torch.inference_mode():
        for _ in range(3):
            frame()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            by_name[ev.name][1] += 1
    busy_ms = sum(t for t, _ in by_name.values())
    k1_ms = sum(t for n, (t, _) in by_name.items() if "points_mlp" in n)
    name = torch.cuda.get_device_name(0)
    print(f"frame wall {wall_ms:.3f} ms under the profiler on {name}; "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"K1 {k1_ms:.3f} ms, {sum(c for _, c in by_name.values())} "
          f"device kernels")
    for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t:9.3f} ms {c:5d}x  {n[:100]}")


if __name__ == "__main__":
    main()
