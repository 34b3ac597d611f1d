"""Where the time of one 800x800 frame goes on the card.

    python3 -m nerfsafetyvalidation_tpu_torch.profile_frame \\
        [--mode fast|guided|baked_h160_ak8|ref_backbone|ref_backbone_ml8]

Loads the flagship teacher (or, for the ref_backbone modes, the hash-grid
reference backbone), refreshes its occupancy 4x as bench.py does, renders
the first held-out spheres pose in the chosen mode (bench.py's settings,
`flagship.MODES`; default baked_h160_ak8), warms up, then renders it once
under `torch.profiler` and prints the device time by kernel, the device
time of the hand-written kernels (K1 points_mlp, K3 sigma_color, K4
fused_mlp), the number of device kernels, and the device's busy share of
the frame's wall time; then the frame's wall time without the profiler.
Needs a CUDA card.
"""

import argparse
import time
from collections import defaultdict

import torch

from . import flagship as F

KERNEL_NAMES = {"K1": "points_mlp", "K3": "sigma_color",
                "K4": "fused_mlp_kernel"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=sorted(F.MODES),
                    default="baked_h160_ak8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs a CUDA device")
    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        if F.MODES[args.mode]["net"].startswith("ref"):
            nets, stored = F.load_ref_nets(dev)
            state = F.refresh(nets["ref"], stored)
        else:
            teacher, stored = F.load_teacher_net(dev)
            nets = {"teacher": teacher, "student": F.load_student_net(dev)}
            state = F.refresh(teacher, stored)
        o, d = F.pose_rays(F.holdout_poses()[0], dev)

        def frame():
            return F.render(args.mode, nets, state, o, d)

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
        t0 = time.perf_counter()
        for _ in range(4):
            frame()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / 4

    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            by_name[ev.name][1] += 1
    busy_ms = sum(t for t, _ in by_name.values())
    n_kernels = sum(c for _, c in by_name.values())
    mine = {k: [sum(v[i] for n, v in by_name.items() if tag in n)
                for i in (0, 1)] for k, tag in KERNEL_NAMES.items()}
    name = torch.cuda.get_device_name(0)
    print(f"mode {args.mode}: frame wall {wall_ms:.3f} ms under the "
          f"profiler on {name}; device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {n_kernels} device kernels; "
          + ", ".join(f"{k} {t:.3f} ms in {c} launches"
                      for k, (t, c) in mine.items())
          + f"; {plain_wall_ms:.3f} ms a frame without the profiler")
    for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t:9.3f} ms {c:5d}x  {n[:100]}")


if __name__ == "__main__":
    main()
