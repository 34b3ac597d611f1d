"""Train the mip-fold teacher, or the hash-grid reference backbone, on the
card with bench.py's whole schedule, and score it.

    python3 -m nerfsafetyvalidation_tpu_torch.train_flagship [--iters N]
        [--seed S ...] [--train-gather foldrow_pallas|foldrow]
    python3 -m nerfsafetyvalidation_tpu_torch.train_flagship --net ref
        [--iters N] [--seed S ...]

It trains `flagship.TRAIN_CFG` (bench.py's `_train_flagship` with
train_gather="foldrow_pallas", so the fold is built by kernel K5 forward
and backward every step; `--train-gather foldrow` builds the same fold as
a slice stack under autograd, the route of the JAX package's training
runs, and launches no K5) from a seeded init: 1920 steps of 4096 rays on the
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

With `--net ref` it trains the hash-grid reference backbone (16 levels x
2 channels, 2^19 rows, the 32 -> 64 -> 16 and 31 -> 64 -> 64 -> 3 nets,
bf16) with bench.py's `_train_ref_backbone` schedule (flagship.
REF_TRAIN_OPT: 960 steps of 4096 rays through the march on the same 48
views), once per seed and route: `fused`, both MLPs through kernel K4 and
its backward (the net of bench.py's config built with `fused=True`; the
CLI's `--ff` builds another topology, `NeRFNetworkFF`), and `plain`, the plain matmul chain
(bench.py's own); then refreshes the occupancy 4x with seeds 100-103 and
renders pose 0 at 800x800 in `ref_backbone` (bench.py's `_ref_line`,
through K4), and prints its PSNR beside 27.018 dB, the port's score of the
committed `refbb.ckpt`, which that schedule trained; with s/step, K4's
launches and the card. Each route's mean over the seeds must lie within
0.5 dB of it (printed as pass or MISS). It also scores the other three
held-out poses and the two validation views, and `refbb.ckpt` itself on
all of them, refreshed with the same seeds, in the same run.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import flagship as F
from .data.synthetic import camera_rays, trace_scene
from .ops.hopper import fold_build, fused_mlp, sigma_color
from .train.metrics import PSNRMeter

GATE_DB = 28.0      # bench.py's spheres gate (bench.py:72-75)
# the JAX package's validation PSNR of its 1920-step teacher through
# `Trainer.evaluate` (ROADMAP.md Queue 3; scripts/bench_budget_convergence.py)
JAX_EVAL_DB = 28.43


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", choices=["teacher", "ref"], default="teacher")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, nargs="+", default=[0])
    ap.add_argument("--train-gather", choices=["foldrow_pallas", "foldrow"],
                    default="foldrow_pallas",
                    help="the teacher's dense fetch in training: the fold "
                         "through K5, or the slice stack under autograd")
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
    splits = F.train_splits()
    if args.net == "ref":
        fused_mlp.build()
        with torch.inference_mode():
            nets, stored = F.load_ref_nets(dev)
            state = F.refresh(nets["ref"], stored, seed=100, reseed=True)
        psnrs = _score_ref(nets["ref"], state, splits)
        print(f"refbb.ckpt, refreshed 4x with seeds 100-103: ref_backbone "
              f"PSNR on the 4 held-out poses at {F.RES}x{F.RES} "
              f"{[round(p, 3) for p in psnrs['holdout']]} (mean "
              f"{np.mean(psnrs['holdout']):.3f}), on the 2 validation "
              f"views at {F.TRAIN_RES}x{F.TRAIN_RES} "
              f"{[round(p, 3) for p in psnrs['val']]}; {smi}", flush=True)
        del nets, stored, state
        results = {r: [train_ref_one(dev, smi, splits,
                                     args.iters or F.REF_TRAIN_ITERS, s,
                                     r == "fused")
                       for s in args.seed] for r in ("fused", "plain")}
        for route, psnrs in results.items():
            mean = float(np.mean(psnrs))
            ok = abs(mean - F.REF_CKPT_DB) <= F.REF_BAND_DB
            print(f"ref {route}: pose-0 PSNR over seeds {args.seed}: "
                  f"{[round(p, 3) for p in psnrs]}, mean {mean:.3f} dB "
                  f"against {F.REF_CKPT_DB} dB (refbb.ckpt), band "
                  f"{F.REF_BAND_DB} dB: {'pass' if ok else 'MISS'}; {smi}")
        return
    fold_build.build()
    sigma_color.build()
    for seed in args.seed:
        train_one(dev, smi, splits, args.iters or F.TRAIN_ITERS, seed,
                  args.train_gather)


def _truths(poses, res=F.RES):
    """The analytic ground truth of each pose at res x res, composited on
    white, [res, res, 3] numpy."""
    out = []
    for pose in poses:
        o_np, d_np = camera_rays(pose, F.intrinsics(res), res, res)
        rgb, alpha, _ = trace_scene(o_np, d_np, scene="spheres")
        out.append(rgb * alpha[..., None] + (1.0 - alpha[..., None]))
    return out


def _score(served, state, poses, truths, res, mode="fast"):
    """(PSNR of the `mode` frame at res x res on each pose against its
    ground truth [res, res, 3] numpy, their mean)."""
    dev = state.density_grid.device
    meter, psnrs = PSNRMeter(), []
    net = F.MODES[mode]["net"]
    with torch.inference_mode():
        for pose, gt in zip(poses, truths):
            o, d = F.pose_rays(pose, dev, res)
            out = F.render(mode, {net: served}, state, o, d, res)
            img = out["image"].cpu().numpy().reshape(res, res, 3)
            if not np.isfinite(img).all():
                raise SystemExit("train_flagship: the frame is not finite")
            psnrs.append(meter.update(img, gt))
    return psnrs, meter.measure()


def train_one(dev, smi, splits, iters, seed, train_gather="foldrow_pallas"):
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
                                           on_epoch=on_epoch,
                                           train_gather=train_gather)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    steps = trainer.global_step
    t_train = epoch_s[-1] - t0
    launches = (fold_build.LAUNCHES, fold_build.LAUNCHES_BWD)
    if (min(launches) < steps) if train_gather == "foldrow_pallas" \
            else any(launches):
        raise SystemExit(f"train_flagship: K5 launched {launches} times in "
                         f"{steps} steps of the {train_gather} route")

    served = F.serving_net(net)
    sigma_color.LAUNCHES = 0
    t0 = time.perf_counter()
    poses = F.holdout_poses()
    psnrs, mean = _score(served, state, poses, _truths(poses), F.RES)
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
    print(f"seed {seed}, train_gather {train_gather}: data {t_data:.2f} s; "
          f"trained {steps} steps in "
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
    print(json.dumps({"seed": seed, "train_gather": train_gather,
                      "steps": steps,
                      "s_per_step": t_train / steps,
                      "steps_per_s": steps / t_train, "last_epoch_loss": last,
                      "k5_launches": list(launches), "psnr": psnrs,
                      "psnr_mean": mean, "gate_db": GATE_DB,
                      "val_psnr": val_psnrs,
                      "val_psnr_mean": val_mean,
                      "val_psnr_evaluate": eval_psnr,
                      "jax_val_psnr_evaluate": JAX_EVAL_DB,
                      "card": smi}), flush=True)


def _score_ref(served, state, splits):
    """`ref_backbone` PSNRs of a served reference backbone: {'holdout': the
    4 held-out poses at F.RES (pose 0 first, the one bench.py scores),
    'val': the dataset's 2 validation views at their size}."""
    poses = F.holdout_poses()
    holdout, _ = _score(served, state, poses, _truths(poses, F.RES), F.RES,
                        mode="ref_backbone")
    val = splits["val"]
    truths = [im[..., :3] * im[..., 3:] + (1.0 - im[..., 3:])
              for im in val["images"]]
    val_psnrs, _ = _score(served, state, val["poses"], truths,
                          val["images"].shape[1], mode="ref_backbone")
    return {"holdout": holdout, "val": val_psnrs}


def train_ref_one(dev, smi, splits, iters, seed, fused):
    """Train the reference backbone through one route, score pose 0;
    returns its PSNR."""
    route = "fused" if fused else "plain"
    opt = F.ref_train_opt(iters=iters, seed=seed)
    dataset = F.train_dataset(dev, opt=opt, splits=splits)
    fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
    epoch_s = []
    t0 = time.perf_counter()
    net, state, trainer = F.train_ref(
        dev, fused, iters=iters, opt=opt, dataset=dataset, seed=seed,
        on_epoch=lambda tr: epoch_s.append(time.perf_counter()))
    torch.cuda.synchronize()
    steps = trainer.global_step
    t_train = epoch_s[-1] - t0
    launches = fused_mlp.LAUNCHES
    if fused_mlp.LAUNCHES_F32 or launches < (2 * steps if fused else 0) \
            or (launches and not fused):
        raise SystemExit(f"train_flagship: K4 launched {launches} times "
                         f"(f32 {fused_mlp.LAUNCHES_F32}) in {steps} steps "
                         f"of the {route} route")
    fused_mlp.LAUNCHES = 0
    scores = _score_ref(F.serving_ref(net), state, splits)
    psnrs = scores["holdout"]
    losses = trainer.stats["loss"]
    print(f"ref {route} seed {seed}: trained {steps} steps in {t_train:.2f}"
          f" s: {t_train / steps:.5f} s/step; K4 launches in training "
          f"{launches} ({launches / steps:.2f} a step); epoch mean loss "
          f"first {losses[0]:.6f}, last {losses[-1]:.6f}; ref_backbone "
          f"pose 0 at {F.RES}x{F.RES}: PSNR {psnrs[0]:.3f} dB "
          f"(refbb.ckpt: {F.REF_CKPT_DB} dB; {fused_mlp.LAUNCHES} K4 "
          f"launches); all 4 held-out poses {[round(p, 3) for p in psnrs]}"
          f" (mean {np.mean(psnrs):.3f}), the 2 validation views "
          f"{[round(p, 3) for p in scores['val']]}; {smi}", flush=True)
    print(json.dumps({"net": "ref", "route": route, "seed": seed,
                      "steps": steps, "s_per_step": t_train / steps,
                      "k4_launches": launches, "first_epoch_loss": losses[0],
                      "last_epoch_loss": losses[-1], "psnr_pose0": psnrs[0],
                      "psnr_holdout": psnrs, "psnr_val": scores["val"],
                      "refbb_psnr": F.REF_CKPT_DB, "card": smi}),
          flush=True)
    del net, state, trainer, dataset
    torch.cuda.empty_cache()
    return psnrs[0]


if __name__ == "__main__":
    main()
