#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nerfsafetyvalidation_tpu_torch) on one
CUDA card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:
  1. device: the card's name, and its power limit from nvidia-smi;
  2. build: kernel K1 (csrc/points_mlp.cu) with nvcc;
  3. kernel: K1 against its plain PyTorch version on 131,072 rows of
     points on real camera rays with the committed 160x6 student, with
     kernel, plain, library (bf16 torch.matmul chain) and bound times;
  4. frame: the baked-student guided 800x800 frame (bench.py's
     baked_h160_ak8 settings) on the "spheres" scene at the four held-out
     poses, through K1; mean PSNR against the analytic ground truth, rays/s,
     and pose 0 rendered again through the plain version and compared.
Then one JSON line per kernel, the nvidia-smi line, and the result line.

The occupancy bitfield is the one stored in bench_assets/flagship.ckpt; the
JAX bench refreshes it through the teacher first, which is not ported yet.

Every failed check raises and ends the run with a non-zero exit; without a
CUDA device the script fails before printing anything.
"""

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
STUDENT = ROOT / "bench_assets" / "bench_student_h160x6.pkl"
CKPT = ROOT / "bench_assets" / "flagship.ckpt"

RES = 800
FOV_X = 0.6911
HOLDOUT = [(0.77, 0.52), (2.31, 0.30), (3.85, 0.65), (5.40, 0.42)]
FRAME = dict(prepass_factor=8, scout_samples=64, max_samples=16, tile=8192,
             adaptive_k=8, adaptive_span_cells=24.0, bg_color=1.0,
             margin_cells=6.0)
ROWS = 8192 * 16            # one K=16 tile of the frame
PSNR_BAR = 28.0             # the spheres gate of bench.py

# Kernel vs plain, both bf16 with f32 sums. The two sum in different
# orders, so an activation now and then rounds to the neighbouring bf16
# value and the difference runs on through the later layers. Changing only
# the sums' precision (f32 -> f64) in the plain chain, on 131,072 rows with
# this student, moved rgb by 0.058 at most (1.4e-5 on average) and sigma by
# 15% of max(|sigma|, 1) at most (5.6e-6 on average). The bounds below are
# about 3x those maxima and 15x those means; a wrong kernel misses the
# means by orders of magnitude.
TOL_RGB_MAX, TOL_RGB_MEAN = 0.15, 2e-4
TOL_SIGMA_MAX, TOL_SIGMA_MEAN = 0.4, 1e-4
# Frame through K1 vs frame through the plain version (same scout, same
# windows). The same f32 -> f64 change moved a 400x400 frame by 0.0067 at
# most and 1.7e-6 on average.
TOL_IMG_MAX, TOL_IMG_MEAN = 0.05, 1e-4

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"[{self.name}] start", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            print(f"[{self.name}] done in "
                  f"{time.perf_counter() - self.t0:.2f} s", flush=True)
        return False


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of fn() over reps back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke runs on a CUDA card only")
    sys.path.insert(0, str(ROOT))
    from nerfsafetyvalidation_tpu_torch.assets import (
        load_renderer_state, load_student, params_from_jax)
    from nerfsafetyvalidation_tpu_torch.config import NetworkConfig
    from nerfsafetyvalidation_tpu_torch.data.rays import (
        get_rays, nerf_matrix_to_ngp)
    from nerfsafetyvalidation_tpu_torch.data.synthetic import (
        camera_rays, orbit_pose, trace_scene)
    from nerfsafetyvalidation_tpu_torch.models import make_network
    from nerfsafetyvalidation_tpu_torch.models.bake import student_config
    from nerfsafetyvalidation_tpu_torch.models.renderer import (
        aabb_of, render_frame_guided)
    from nerfsafetyvalidation_tpu_torch.ops.freq_encoding import freq_encode
    from nerfsafetyvalidation_tpu_torch.ops.hopper import points_mlp
    from nerfsafetyvalidation_tpu_torch.ops.ray_ops import near_far_from_aabb
    from nerfsafetyvalidation_tpu_torch.ops.sh_encoding import sh_encode

    # float32 products in full float32 (the plain version's sums)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}")

    with Phase("build"):
        t0 = time.perf_counter()
        lib = points_mlp.build()
        print(f"K1 built in {time.perf_counter() - t0:.2f} s: "
              f"{lib.relative_to(ROOT)}")
        for line in points_mlp.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    teacher = NetworkConfig(bound=1.0, compute_dtype="bfloat16",
                            grid_size=128)
    cfg = replace(student_config(teacher, multires=12, hidden_dim=160,
                                 num_layers=6), fused=True)
    net = make_network(cfg, params_from_jax(load_student(STUDENT), dev),
                       device=dev)
    sn, cn = list(net.sigma_net), list(net.color_net)
    fx = 0.5 * RES / np.tan(0.5 * FOV_X)
    intr = (fx, fx, RES / 2, RES / 2)
    poses = [orbit_pose(th, ph, 2.4) for th, ph in HOLDOUT]

    def rays_of(pose):
        r = get_rays(nerf_matrix_to_ngp(pose, scale=1.0,
                                        offset=(0.0, 0.0, 0.0))[None],
                     intr, RES, RES, device=dev)
        return r["rays_o"][0].contiguous(), r["rays_d"][0].contiguous()

    with Phase("kernel"), torch.inference_mode():
        # points on pose 0's rays, spread over the frame, uniform in depth
        # over each ray's [near, far] inside the box
        o, d = rays_of(poses[0])
        pick = torch.arange(ROWS, device=dev) * (o.shape[0] // ROWS)
        o, d = o[pick], d[pick]
        near, far = near_far_from_aabb(o, d, aabb_of(cfg, dev), cfg.min_near)
        inside = far > near
        near = torch.where(inside, near, cfg.min_near)
        far = torch.where(inside, far, 4.0)
        gen = torch.Generator(device=dev).manual_seed(0)
        u = torch.rand(ROWS, generator=gen, device=dev)
        x = torch.clamp(o + (near + u * (far - near))[:, None] * d,
                        -cfg.bound, cfg.bound).contiguous()
        sh = sh_encode(d).to(torch.bfloat16).contiguous()

        def kernel():
            return points_mlp.fused_points_sigma_color(x, sh, sn, cn, 12)

        def plain():
            return points_mlp.fused_points_sigma_color_plain(x, sh, sn, cn,
                                                             12)

        bf = torch.bfloat16
        sn_bf = [w.to(bf) for w in sn]
        cn_bf = [w.to(bf) for w in cn]

        def library():
            # the same chain as bf16 torch.matmul calls (a yardstick only)
            h = freq_encode(x, 12).to(bf)
            for i, w in enumerate(sn_bf):
                h = h @ w
                if i != len(sn_bf) - 1:
                    h = torch.relu(h)
            sigma = torch.exp(torch.clamp(h[:, 0].float(), -15.0, 15.0))
            g = torch.cat([sh, h[:, 1:]], dim=-1)
            for i, w in enumerate(cn_bf):
                g = g @ w
                if i != len(cn_bf) - 1:
                    g = torch.relu(g)
            return sigma, torch.sigmoid(g[:, :3].float())

        s_k, c_k = kernel()
        torch.cuda.synchronize()
        s_p, c_p = plain()
        check(s_k.shape == (ROWS,) and c_k.shape == (ROWS, 3),
              "K1 output shapes")
        check(bool(torch.isfinite(s_k).all() and torch.isfinite(c_k).all()),
              "K1 outputs are not all finite")
        rgb_err = (c_k - c_p).abs()
        sig_abs = (s_k - s_p).abs()
        sig_rel = sig_abs / s_p.abs().clamp(min=1.0)
        max_abs_err = max(float(rgb_err.max()), float(sig_abs.max()))
        print(f"K1 vs plain on {ROWS} rows: rgb max abs "
              f"{float(rgb_err.max()):.3e} mean {float(rgb_err.mean()):.3e};"
              f" sigma max rel {float(sig_rel.max()):.3e} mean "
              f"{float(sig_rel.mean()):.3e} (max abs "
              f"{float(sig_abs.max()):.3e}"
              f" at sigma up to {float(s_p.max()):.3e})")
        check(float(rgb_err.max()) <= TOL_RGB_MAX
              and float(rgb_err.mean()) <= TOL_RGB_MEAN,
              f"K1 rgb disagrees with the plain version (tolerance max "
              f"{TOL_RGB_MAX}, mean {TOL_RGB_MEAN})")
        check(float(sig_rel.max()) <= TOL_SIGMA_MAX
              and float(sig_rel.mean()) <= TOL_SIGMA_MEAN,
              f"K1 sigma disagrees with the plain version (tolerance max rel "
              f"{TOL_SIGMA_MAX}, mean {TOL_SIGMA_MEAN})")

        kernel_ms = cuda_ms(torch, kernel, 50)
        plain_ms = cuda_ms(torch, plain, 10)
        library_ms = cuda_ms(torch, library, 20)
        macs = sum(w.shape[0] * w.shape[1] for w in sn + cn)
        weight_bytes = 2 * sum(w.numel() for w in sn + cn)
        flops = 2.0 * ROWS * macs
        nbytes = ROWS * (3 * 4 + 16 * 2 + 8 * 4) + weight_bytes
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"K1 at {ROWS} rows ({macs} MAC/row, {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB): kernel_ms {kernel_ms:.4f}, plain_ms "
              f"{plain_ms:.4f}, library_ms {library_ms:.4f}, bound_ms "
              f"{bound_ms:.4f} ({bound_by}); {smi}")

    with Phase("frame"), torch.inference_mode():
        state = load_renderer_state(CKPT, device=dev)
        views = []
        for pose in poses:
            o_np, d_np = camera_rays(pose, intr, RES, RES)
            gt_rgb, gt_alpha, _ = trace_scene(o_np, d_np, scene="spheres")
            gt = gt_rgb * gt_alpha[..., None] + (1.0 - gt_alpha[..., None])
            views.append(rays_of(pose) + (gt,))

        def render(o, d, plain_field=False):
            return render_frame_guided(net, state, o, d, RES, RES,
                                       plain_field=plain_field, **FRAME)

        points_mlp.LAUNCHES = 0
        first = []
        t0 = time.perf_counter()
        for o, d, _ in views:
            first.append(render(o, d))
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for o, d, _ in views:
            render(o, d)
        torch.cuda.synchronize()
        t_steady = time.perf_counter() - t0
        launches = points_mlp.LAUNCHES
        check(launches > 0, "the frames never launched K1")

        n_rays = RES * RES
        psnrs = []
        for out, (_, _, gt) in zip(first, views):
            img = out["image"]
            check(img.shape == (n_rays, 3)
                  and bool(torch.isfinite(img).all()),
                  "frame image is not finite [N, 3]")
            pred = img.cpu().numpy().reshape(RES, RES, 3).astype(np.float64)
            psnrs.append(float(-10.0 * np.log10(
                max(np.mean((pred - gt) ** 2), 1e-10))))
        buckets = [np.bincount(o["tile_bucket"], minlength=3).tolist()
                   for o in first]
        rays_per_s = len(views) * n_rays / t_steady
        print(f"PSNR per pose {[round(p, 3) for p in psnrs]}, mean "
              f"{np.mean(psnrs):.3f} dB (bar {PSNR_BAR})")
        print(f"tile buckets [empty, K8, K16] per pose: {buckets}")
        print(f"K1 launches: {launches} in {2 * len(views)} frames")
        print(f"frames: first pass {t_first:.3f} s, steady pass "
              f"{t_steady:.3f} s for {len(views)} frames = "
              f"{rays_per_s:.0f} rays/s on {smi}")
        check(np.mean(psnrs) >= PSNR_BAR,
              f"mean PSNR {np.mean(psnrs):.3f} dB under {PSNR_BAR}")

        plain = render(views[0][0], views[0][1], plain_field=True)
        check(points_mlp.LAUNCHES == launches,
              "the plain frame launched K1")
        check(bool((plain["tile_bucket"] == first[0]["tile_bucket"]).all()),
              "plain frame chose other tile buckets")
        err = (plain["image"] - first[0]["image"]).abs()
        print(f"pose 0 kernel frame vs plain frame: image max abs "
              f"{float(err.max()):.3e}, mean {float(err.mean()):.3e}")
        check(float(err.max()) <= TOL_IMG_MAX
              and float(err.mean()) <= TOL_IMG_MEAN,
              f"kernel frame disagrees with the plain frame (tolerance max "
              f"{TOL_IMG_MAX}, mean {TOL_IMG_MEAN})")

    print(f"total {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_points_sigma_color", "route": "cuda",
        "source": "nerfsafetyvalidation_tpu_torch/csrc/points_mlp.cu",
        "replaces": "nerfsafetyvalidation_tpu/ops/pallas/render_mlp.py:480",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
