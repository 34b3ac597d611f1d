"""The batched rollout throughput benchmark (the root bench_rollouts.py) on
the card:

    python3 -m nerfsafetyvalidation_tpu_torch.bench_rollouts

Two JSON lines, each {"metric", "value", "unit", "vs_baseline", "device"},
the metric strings the JAX script's:

  1. the core engine (`BatchedRolloutEngine`: dynamics, SDF lookup,
     likelihood): 8,192 sims x 12 steps on a 64^3 SDF with a wall at
     |x| > 0.7 m, hover actions, the reference's disturbance std; one
     warm-up run, then the mean of 5 runs;
  2. the full engine (`FullBatchedRolloutEngine`, `uniform` path): the same
     SDF and actions, m = 16 sims, 64^2 observations of 32 samples a ray,
     obs_group 2, through an 8-level hash-grid `NeRFNetwork` (desired
     resolution 512, float32, unfused, as the JAX script builds it) from a
     seeded init; one warm-up run, then the mean of 3.

Each timed run ends in `torch.cuda.synchronize()`. vs_baseline divides by
an optimistic 1 rollout/s for the reference's sequential loop, as the JAX
script does. `device` is the card's name and power limit (nvidia-smi), or
null on the CPU. The sizes are module constants; `main(device="cpu")` at
toy sizes is how the tests run it."""

import json
import time

import numpy as np
import torch

from .bench import card
from .config import NetworkConfig
from .models import make_network
from .validation.batched import (BatchedRolloutEngine,
                                 FullBatchedRolloutEngine)

REFERENCE_ROLLOUTS_PER_SEC = 1.0
STEPS = 12                  # envConfig.json's planner steps
N_SIMS = 8192               # the core engine's population
N_ITERS = 5
M_FULL = 16                 # the full engine's population
OBS_RES = 64
RENDER_STEPS = 32
N_ITERS_FULL = 3


def _setting():
    """(actions [T, 4], the wall SDF [64]^3, the engines' shared
    arguments)."""
    actions = np.tile(np.asarray([10.0, 0.0, 0.0, 0.0], dtype=np.float32),
                      (STEPS, 1))
    g = 64
    xs = np.linspace(-1, 1, g)
    sdf = np.ones((g, g, g), dtype=np.float32)
    sdf[np.abs(xs)[:, None, None] * np.ones((1, g, g)) > 0.7] = 0.0
    return dict(
        actions=actions, dt=2.0 / STEPS, g=10.0, mass=1.0, I=np.eye(3),
        sdf=sdf, sdf_start=[-1, -1, -1], granularity=g / 2,
        noise_mean=np.zeros(12),
        noise_std=np.asarray([2e-2] * 3 + [1e-2] * 3 + [2e-2] * 3
                             + [1e-2] * 3, dtype=np.float32),
        start_state=np.zeros(12, dtype=np.float32))


def _timed(run, n_iters, sync):
    """Mean seconds of a run after one warm-up run."""
    run()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        run()
    sync()
    return (time.perf_counter() - t0) / n_iters


def main(device="cuda"):
    """Runs both measurements; prints the two JSON lines and returns
    them."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_rollouts: no CUDA device")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    name = card() if dev.type == "cuda" else None
    kw = _setting()
    lines = []

    eng = BatchedRolloutEngine(device=dev, **kw)
    noises = eng.sample_noises(torch.Generator(device=dev).manual_seed(0),
                               N_SIMS)
    dt = _timed(lambda: eng.run(noises), N_ITERS, sync)
    rate = N_SIMS / dt
    lines.append({
        "metric": f"rollouts/sec (batched {STEPS}-step MC rollouts, "
                  f"dynamics+SDF+likelihood core ONLY, population {N_SIMS})",
        "value": round(rate), "unit": "rollouts/s",
        "vs_baseline": round(rate / REFERENCE_ROLLOUTS_PER_SEC, 1),
        "device": name})
    print(json.dumps(lines[-1]), flush=True)

    cfg = NetworkConfig(num_levels=8, desired_resolution=512, bound=1.0)
    net = make_network(cfg, None, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    feng = FullBatchedRolloutEngine(
        net=net, obs_res=OBS_RES, render_steps=RENDER_STEPS,
        base_intrinsics=(90.0, 90.0, 32, 32), base_res=64, obs_group=2,
        device=dev, **kw)
    z = torch.randn((M_FULL, STEPS, 12), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    dtf = _timed(lambda: feng.run(z), N_ITERS_FULL, sync)
    rate = M_FULL / dtf
    lines.append({
        "metric": f"rollouts/sec (FULL-fidelity {STEPS}-step rollouts: "
                  f"{OBS_RES}^2 NeRF obs render + Gaussian UQ + reward + SDF "
                  f"in-scan, population {M_FULL})",
        "value": round(rate, 2), "unit": "rollouts/s",
        "vs_baseline": round(rate / REFERENCE_ROLLOUTS_PER_SEC, 1),
        "device": name})
    print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
