"""Train the mip-fold teacher on the card with bench.py's whole schedule,
and score it.

    python3 -m nerfsafetyvalidation_tpu_torch.train_flagship [--iters N]
        [--seed S ...]

It trains `flagship.TRAIN_CFG` (bench.py's `_train_flagship` with
train_gather="foldrow_pallas", so the fold is built by kernel K5 forward
and backward every step) from a seeded init: 1920 steps of 4096 rays on the
48-view 200x200 spheres set, the occupancy refreshed every 16 steps. Then it
refreshes the occupancy 4x through the trained field, renders bench.py's
`fast` frame at 800x800 on the four held-out poses through K3, and prints
the last epoch's train loss, s/step and steps/s (host clock around the
epochs, each ending in a device wait), the K5 launches, the mean PSNR
against the analytic ground truth beside bench.py's 28 dB spheres gate,
and the card's name and power limit; then one JSON line of those numbers.
It also scores the dataset's two 200x200 validation views, the views on
which the JAX package's training runs report their validation PSNR: in
the `fast` frame, and through the trainer's `evaluate` as the JAX runs
score them (the staged render, 128 uniform steps, no upsampling; JAX's
28.43 dB, scripts/bench_budget_convergence.py). With several seeds (each
seeds the init, the pixel draws and the trainer's draws; 0 is bench.py's
run) it trains once per seed and prints one JSON line each.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import flagship as F
from .data.synthetic import camera_rays, trace_scene
from .ops.hopper import fold_build, sigma_color
from .train.metrics import PSNRMeter

GATE_DB = 28.0      # bench.py's spheres gate (bench.py:72-75)
# the JAX package's validation PSNR of its 1920-step teacher through
# `Trainer.evaluate` (ROADMAP.md Queue 3; scripts/bench_budget_convergence.py)
JAX_EVAL_DB = 28.43


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=F.TRAIN_ITERS)
    ap.add_argument("--seed", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_flagship runs on a CUDA card only")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fold_build.build()
    sigma_color.build()

    splits = F.train_splits()
    for seed in args.seed:
        train_one(dev, smi, splits, args.iters, seed)


def _score(served, state, poses, truths, res):
    """(PSNR of the `fast` frame at res x res on each pose against its
    ground truth [res, res, 3] numpy, their mean)."""
    dev = state.density_grid.device
    meter, psnrs = PSNRMeter(), []
    with torch.inference_mode():
        for pose, gt in zip(poses, truths):
            o, d = F.pose_rays(pose, dev, res)
            out = F.render("fast", {"teacher": served}, state, o, d, res)
            img = out["image"].cpu().numpy().reshape(res, res, 3)
            if not np.isfinite(img).all():
                raise SystemExit("train_flagship: the frame is not finite")
            psnrs.append(meter.update(img, gt))
    return psnrs, meter.measure()


def train_one(dev, smi, splits, iters, seed):
    opt = F.train_opt(iters=iters, seed=seed)
    t0 = time.perf_counter()
    dataset = F.train_dataset(dev, opt=opt, splits=splits)
    t_data = time.perf_counter() - t0
    fold_build.LAUNCHES = fold_build.LAUNCHES_BWD = 0
    epoch_s = []

    def on_epoch(trainer):
        epoch_s.append(time.perf_counter())
        print(f"epoch {trainer.epoch}: step {trainer.global_step}, mean "
              f"loss {trainer.stats['loss'][-1]:.6f}", flush=True)

    t0 = time.perf_counter()
    net, state, trainer = F.train_flagship(dev, iters=iters, opt=opt,
                                           dataset=dataset, seed=seed,
                                           on_epoch=on_epoch)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    steps = trainer.global_step
    t_train = epoch_s[-1] - t0
    launches = (fold_build.LAUNCHES, fold_build.LAUNCHES_BWD)

    served = F.serving_net(net)
    sigma_color.LAUNCHES = 0
    t0 = time.perf_counter()
    poses = F.holdout_poses()
    truths = []
    for pose in poses:
        o_np, d_np = camera_rays(pose, F.intrinsics(), F.RES, F.RES)
        rgb, alpha, _ = trace_scene(o_np, d_np, scene="spheres")
        truths.append(rgb * alpha[..., None] + (1.0 - alpha[..., None]))
    psnrs, mean = _score(served, state, poses, truths, F.RES)
    t_render = time.perf_counter() - t0
    val = splits["val"]
    res_val = val["images"].shape[1]
    val_truths = [im[..., :3] * im[..., 3:] + (1.0 - im[..., 3:])
                  for im in val["images"]]
    val_psnrs, val_mean = _score(served, state, val["poses"], val_truths,
                                 res_val)
    t0 = time.perf_counter()
    val_set = F.train_dataset(dev, opt=opt, splits=splits, type="val")
    trainer.evaluate(val_set.dataloader())
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    eval_psnr = trainer.stats["results"][-1]
    last = trainer.stats["loss"][-1]
    print(f"seed {seed}: data {t_data:.2f} s; trained {steps} steps in "
          f"{t_train:.2f} s: {t_train / steps:.5f} s/step, "
          f"{steps / t_train:.3f} steps/s (with the final 4x refresh "
          f"{t_all:.2f} s); last epoch's mean loss {last:.6f}; K5 launches "
          f"forward {launches[0]}, backward {launches[1]}")
    print(f"seed {seed}: fast at {F.RES}x{F.RES}, 4 held-out poses: PSNR "
          f"{[round(p, 3) for p in psnrs]}, mean {mean:.3f} dB (gate "
          f"{GATE_DB}: {'pass' if mean >= GATE_DB else 'MISS'}); "
          f"{sigma_color.LAUNCHES} K3 launches; {t_render:.2f} s; fast at "
          f"{res_val}x{res_val} on the 2 validation views: "
          f"{[round(p, 3) for p in val_psnrs]}, mean {val_mean:.3f}"
          f" dB")
    print(f"seed {seed}: evaluate (staged render, {opt.num_steps} uniform "
          f"steps, upsampling {opt.upsample_steps}) on the 2 validation "
          f"views: PSNR {eval_psnr:.3f} dB (JAX's 1920-step run: "
          f"{JAX_EVAL_DB} dB), mean loss {trainer.stats['valid_loss'][-1]:.6f}"
          f"; {t_eval:.2f} s")
    print(smi)
    print(json.dumps({"seed": seed, "steps": steps,
                      "s_per_step": t_train / steps,
                      "steps_per_s": steps / t_train, "last_epoch_loss": last,
                      "k5_launches": list(launches), "psnr": psnrs,
                      "psnr_mean": mean, "gate_db": GATE_DB,
                      "val_psnr": val_psnrs,
                      "val_psnr_mean": val_mean,
                      "val_psnr_evaluate": eval_psnr,
                      "jax_val_psnr_evaluate": JAX_EVAL_DB,
                      "card": smi}), flush=True)


if __name__ == "__main__":
    main()
