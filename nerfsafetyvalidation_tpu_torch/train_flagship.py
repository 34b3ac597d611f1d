"""Train the mip-fold teacher, the hash-grid reference backbone or a
distilled student on the card with bench.py's whole schedule, and score
it.

    python3 -m nerfsafetyvalidation_tpu_torch.train_flagship [--iters N]
        [--seed S ...] [--train-gather foldrow_pallas|foldrow]
    python3 -m nerfsafetyvalidation_tpu_torch.train_flagship --net ref
        [--iters N] [--seed S ...]
    python3 -m nerfsafetyvalidation_tpu_torch.train_flagship --net student
        [--hidden 160|192|256] [--scene spheres|gauntlet] [--seed S ...]
        [--distill-steps N] [--ft-steps M]

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

With `--net student` it runs bench.py's cold student path (`_get_student`,
bench.py:267-351): it loads the scene's committed teacher
(`bench_assets/flagship{,_gauntlet}.ckpt`) as the served one (through K3)
and refreshes its occupancy 4x, then, once per seed, distills the 6-layer
student of width `--hidden` from it and fine-tunes it in pixel space at
the width's schedule (`flagship.student_schedule`: 24,000 + 12,000 steps
at 160; `--distill-steps` / `--ft-steps` override it), saves it as
bench.py's pkl under `.bench_cache/`, loads it back as the fused serving
student (through K1) and renders the scene's four held-out poses at
800x800 in `fast` and in the baked modes of that width (`baked_h160_ak8`
and `baked_h160` at 160). The committed student of that width is scored
in the same modes in the same run. It prints each mode's mean and min
PSNR against bench.py's gate for the scene (spheres 28 dB; gauntlet
relative to `fast`, 1.5 dB below it, capped at 24), pass or MISS; s/step
of each phase (host clock, a device wait at each phase's end); K3's
launches a step of each phase and K1's a frame; the final losses; the
share of the teacher's rows whose s0 K3 clipped at +-15 (sigma at
exp(+-15)); the card's name and power limit; then one JSON line a seed.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import bench as B
from . import flagship as F
from .assets import load_student, params_from_jax, save_student
from .data.synthetic import camera_rays, trace_scene
from .models import make_network
from .ops.hopper import fold_build, fused_mlp, points_mlp, sigma_color
from .train.metrics import PSNRMeter

GATE_DB = 28.0      # bench.py's spheres gate (bench.py:72-75)
# the JAX package's validation PSNR of its 1920-step teacher through
# `Trainer.evaluate` (ROADMAP.md Queue 3; scripts/bench_budget_convergence.py)
JAX_EVAL_DB = 28.43


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", choices=["teacher", "ref", "student"],
                    default="teacher")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, nargs="+", default=[0])
    ap.add_argument("--train-gather", choices=["foldrow_pallas", "foldrow"],
                    default="foldrow_pallas",
                    help="the teacher's dense fetch in training: the fold "
                         "through K5, or the slice stack under autograd")
    ap.add_argument("--hidden", type=int, choices=sorted(F.STUDENT_WIDTHS),
                    default=160, help="--net student: the student's width")
    ap.add_argument("--scene", choices=F.SCENES, default="spheres",
                    help="--net student: the bench scene")
    ap.add_argument("--distill-steps", type=int, default=None,
                    help="--net student: distill steps (default: the "
                         "width's schedule)")
    ap.add_argument("--ft-steps", type=int, default=None,
                    help="--net student: fine-tune steps (default: the "
                         "width's schedule)")
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
    if args.net == "student":
        student_main(dev, smi, args)
        return
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


def _truths(poses, res=F.RES, scene="spheres"):
    """The analytic ground truth of each pose at res x res, composited on
    white, [res, res, 3] numpy."""
    out = []
    for pose in poses:
        o_np, d_np = camera_rays(pose, F.intrinsics(res), res, res)
        rgb, alpha, _ = trace_scene(o_np, d_np, scene=scene)
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


# sigma where K3 clips the teacher's s0 at +-15, with a margin for the
# kernel's exp
E15_HI = float(np.exp(15.0)) * (1.0 - 1e-3)
E15_LO = float(np.exp(-15.0)) * (1.0 + 1e-3)
# the distillation's progress line, every this many steps of a phase
LOG_EVERY = 2000


class ClipCount(torch.nn.Module):
    """The served teacher, counting the rows it shades and those whose
    sigma K3 clipped (s0 >= 15 or <= -15; the unfused trunc_exp does not
    clip), as device tensors."""

    def __init__(self, net):
        super().__init__()
        self.net, self.cfg = net, net.cfg
        self.rows, self.hi, self.lo = 0, 0, 0

    def forward(self, x, d):
        sigma, rgb = self.net(x, d)
        self.rows += sigma.numel()
        self.hi = self.hi + (sigma >= E15_HI).sum()
        self.lo = self.lo + (sigma <= E15_LO).sum()
        return sigma, rgb

    def counts(self):
        rows, hi, lo = int(self.rows), int(self.hi), int(self.lo)
        return {"rows": rows, "s0_ge_15": hi, "s0_le_-15": lo,
                "share_ge_15": hi / max(rows, 1),
                "share_le_-15": lo / max(rows, 1)}


def student_cache_path(scene, hidden, layers, K, schedule, seed):
    """bench.py's cache name of a student (`_get_student`), under
    .bench_cache/, with the seed appended for seeds other than 0."""
    tag = "" if scene == "spheres" else f"_{scene}"
    if K != 16:
        tag += f"_k{K}"
    if (hidden, layers) != (256, 6):
        tag += f"_h{hidden}x{layers}"
    if tuple(schedule) != F.student_schedule(hidden, layers):
        tag += f"_d{schedule[0]}f{schedule[1]}"
    if seed:
        tag += f"_s{seed}"
    return F.ROOT / ".bench_cache" / f"bench_student{tag}.pkl"


def _score_modes(served, state, poses, truths, modes):
    """{mode: (mean, min, per-pose PSNRs, K1 launches a frame)} of the
    served net in each mode at F.RES."""
    out = {}
    for mode in modes:
        k1 = sum(points_mlp.LAUNCHES_BY_WIDTH.values())
        psnrs, mean = _score(served, state, poses, truths, F.RES, mode)
        out[mode] = (mean, min(psnrs), psnrs,
                     (sum(points_mlp.LAUNCHES_BY_WIDTH.values()) - k1)
                     / len(poses))
    return out


def _gated(scores, gates, modes):
    """{mode: {'psnr_mean', 'psnr_min', 'psnr_poses', 'pass',
    'k1_launches_per_frame'}} against the scene's bars."""
    return {m: {"psnr_mean": scores[m][0], "psnr_min": scores[m][1],
                "psnr_poses": scores[m][2],
                "pass": bool(scores[m][0] >= gates["gate_db"]
                             and scores[m][1] >= gates["gate_min_db"]),
                "k1_launches_per_frame": scores[m][3]} for m in modes}


def student_main(dev, smi, args):
    """`--net student`: bench.py's cold student path on one scene, once a
    seed, beside the committed student."""
    t_all = time.perf_counter()
    hidden, layers, K = args.hidden, 6, 16
    d_def, f_def = F.student_schedule(hidden, layers)
    schedule = (args.distill_steps if args.distill_steps is not None
                else d_def, args.ft_steps if args.ft_steps is not None
                else f_def)
    name = f"student_h{hidden}"
    modes = [m for m in B.MODE_ORDER if F.MODES[m]["net"] == name]
    if dev.type == "cuda":
        sigma_color.build()
        points_mlp.build()
    with torch.no_grad():
        teacher, stored = F.load_teacher_net(dev, args.scene)
        state = F.refresh(teacher, stored)
    poses = F.holdout_poses()
    truths = _truths(poses, F.RES, args.scene)
    fast = _score_modes(teacher, state, poses, truths, ["fast"])
    anchor = fast["fast"][:2] if args.scene in B.REL_GATE else None
    gates = B.scene_gates(args.scene, anchor)
    committed = F.load_student_net(dev, args.scene, hidden)
    ref = _gated(_score_modes(committed, state, poses, truths, modes), gates,
                 modes)
    del committed
    print(f"{args.scene}: fast {fast['fast'][0]:.3f} dB mean, "
          f"{fast['fast'][1]:.3f} min; gate mean >= {gates['gate_db']:.2f},"
          f" min >= {gates['gate_min_db']:.2f}; committed h{hidden}x{layers}"
          f" student: " + "; ".join(
              f"{m} {v['psnr_mean']:.3f} / {v['psnr_min']:.3f} "
              f"({'pass' if v['pass'] else 'MISS'})"
              for m, v in ref.items()) + f"; {smi}", flush=True)
    for seed in args.seed:
        distill_one(dev, smi, args.scene, hidden, layers, K, schedule, seed,
                    teacher, state, (poses, truths), modes, gates, fast, ref)
    print(f"train_flagship --net student: {time.perf_counter() - t_all:.2f}"
          f" s in all; {smi}", flush=True)


def distill_one(dev, smi, scene, hidden, layers, K, schedule, seed, teacher,
                state, views, modes, gates, fast, ref):
    """One seed of `--net student`: distill and fine-tune, save and reload
    the pkl, score the served student on `views` (poses, truths); prints
    its lines and its JSON line."""
    counted = ClipCount(teacher)
    steps = dict(zip(("distill", "finetune"), schedule))
    rec = {p: dict(losses=[], k3=[], t=None) for p in steps}
    sigma_color.LAUNCHES = 0
    t0 = time.perf_counter()
    last = [0]

    def on_step(phase, i, loss):
        r = rec[phase]
        r["losses"].append(loss)
        r["k3"].append(sigma_color.LAUNCHES - last[0])
        last[0] = sigma_color.LAUNCHES
        if (i + 1) % LOG_EVERY == 0:
            print(f"seed {seed} {phase} step {i + 1}/{steps[phase]}: loss "
                  f"{float(loss):.6f}; {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if i + 1 == steps[phase]:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            r["t"] = time.perf_counter()

    gen = torch.Generator(device=dev).manual_seed(seed)
    _, sparams, final = F.distill_student(
        counted, state, hidden, layers, K, generator=gen, schedule=schedule,
        on_step=on_step)
    t_d = rec["distill"]["t"] - t0
    t_f = rec["finetune"]["t"] - rec["distill"]["t"]
    for phase, r in rec.items():
        if len(r["k3"]) != steps[phase] or (dev.type == "cuda" and min(
                r["k3"], default=0) < 1):
            raise SystemExit(f"train_flagship: K3 did not launch in every "
                             f"{phase} step ({len(r['k3'])} steps)")
    clip = counted.counts()
    path = student_cache_path(scene, hidden, layers, K, schedule, seed)
    path.parent.mkdir(exist_ok=True)
    save_student(path, sparams, schedule, K, hidden, layers)
    back = params_from_jax(load_student(path), dev)
    same = all(torch.equal(a, b) for k in ("sigma_net", "color_net")
               for a, b in zip(back[k], sparams[k]))
    if not same:
        raise SystemExit("train_flagship: the saved student does not reload "
                         "bit-equal")
    served = make_network(F.student_cfg(hidden), back, device=dev)
    got = _gated(_score_modes(served, state, *views, modes), gates, modes)
    if dev.type == "cuda" and min(v["k1_launches_per_frame"]
                                  for v in got.values()) < 1:
        raise SystemExit("train_flagship: K1 did not launch in a frame of "
                         "the distilled student")

    def window(losses, a, b):
        return float(torch.stack(losses[a:b]).mean()) if losses else None
    losses = {p: {"final": final[p],
                  "first_100_mean": window(r["losses"], 0, 100),
                  "last_100_mean": window(r["losses"], -100, None)}
              for p, r in rec.items()}
    per_step = {p: {"s_per_step": (t_d if p == "distill" else t_f)
                    / max(steps[p], 1),
                    "seconds": t_d if p == "distill" else t_f,
                    "k3_launches_per_step": sum(r["k3"]) / max(steps[p], 1),
                    "k3_launches_min": min(r["k3"], default=0)}
                for p, r in rec.items()}
    print(f"seed {seed}: distilled h{hidden}x{layers} on {scene} at "
          f"{schedule[0]} + {schedule[1]} steps: distill "
          f"{per_step['distill']['s_per_step']:.5f} s/step "
          f"({t_d:.1f} s), fine-tune {per_step['finetune']['s_per_step']:.5f}"
          f" s/step ({t_f:.1f} s); K3 launches a step "
          f"{per_step['distill']['k3_launches_per_step']:.2f} / "
          f"{per_step['finetune']['k3_launches_per_step']:.2f}; final losses"
          f" {final['distill']:.6f} / {final['finetune']:.6f}; K3 rows "
          f"{clip['rows']}, s0 >= 15 on {clip['s0_ge_15']} "
          f"({clip['share_ge_15']:.3e}), s0 <= -15 on {clip['s0_le_-15']} "
          f"({clip['share_le_-15']:.3e}); saved {path.name}", flush=True)
    for m, v in got.items():
        c = ref[m]
        print(f"seed {seed}: {m} at {F.RES}x{F.RES}, 4 held-out poses: PSNR "
              f"mean {v['psnr_mean']:.3f}, min {v['psnr_min']:.3f} (gate "
              f"{gates['gate_db']:.2f} / {gates['gate_min_db']:.2f}: "
              f"{'pass' if v['pass'] else 'MISS'}); committed student "
              f"{c['psnr_mean']:.3f} / {c['psnr_min']:.3f} "
              f"({'pass' if c['pass'] else 'MISS'}); K1 launches a frame "
              f"{v['k1_launches_per_frame']:.1f}", flush=True)
    print(smi)
    print(json.dumps({
        "net": "student", "scene": scene, "hidden": hidden,
        "layers": layers, "K": K, "seed": seed, "schedule": list(schedule),
        "phases": per_step, "losses": losses, "k3_clipping": clip,
        "gates": gates, "fast": {"psnr_mean": fast["fast"][0],
                                 "psnr_min": fast["fast"][1],
                                 "psnr_poses": fast["fast"][2]},
        "modes": got, "committed": ref,
        "gate_pass": all(v["pass"] for v in got.values()),
        "pkl": str(path.relative_to(F.ROOT)), "card": smi}), flush=True)
    del served
    if dev.type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
