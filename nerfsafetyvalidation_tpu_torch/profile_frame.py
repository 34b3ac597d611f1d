"""Where the time of one 800x800 frame, or of one training step, goes on
the card.

    python3 -m nerfsafetyvalidation_tpu_torch.profile_frame \\
        [--mode fast|guided|baked_h160_ak8|baked_h160|baked_h192|baked|
                ref_backbone|ref_backbone_ml8|staged|staged_bf16|train|
                train_O_ff|train_ff|rollout_scout|rollout_fast|
                rollout_guided|rollout_uniform]

Loads the flagship teacher (or, for the ref_backbone modes, the hash-grid
reference backbone), refreshes its occupancy 4x as bench.py does, renders
the first held-out spheres pose in the chosen mode (bench.py's settings,
`flagship.MODES`; default baked_h160_ak8), warms up, then renders it once
under `torch.profiler` and prints the device time by kernel, the device
time of the hand-written kernels (K1 points_mlp, K3 sigma_color, K4
fused_mlp, K5 fold_build), the number of device kernels, and the device's
busy share of the frame's wall time; then the frame's wall time without the
profiler. The staged modes (`staged`, `staged_bf16`: the reference
backbone through the staged render, 157 chunks of 4,096 rays x 512
samples) read no occupancy and warm up with one frame; they also print the
device time of the corner hash-grid encode, from CUDA events around every
`encode_pos` call of one more frame.

`--mode train` does the same for training steps of the teacher at full
width (flagship.TRAIN_CFG, through K5) from a seeded init on the spheres
set: 20 steps of warm-up (two full refreshes among them), 4 steps under the
profiler, then 8 steps without it; and apart, with a device wait around
each, the march of one batch, a full and a partial refresh.
`--mode rollout_scout|rollout_fast|rollout_guided|rollout_uniform` does it
for one step of the batched rollout engine (flagship.rollout_engine: 16
sims, 100x100 observations of each path's net) and times one observation,
the 16, and the UQ's Adam apart.
`--mode train_O_ff` and `train_ff` do it for the training CLI's steps
(`main_nerf`'s trainer, net and options for `-O --ff` or `--ff` at the
CLI's defaults but --bound 1 --scale 1) of `NeRFNetworkFF`, the hash-grid
net in bfloat16, from a seeded init on the same 48 views: K4 and its
backward, through the march (`-O`) or 512 uniform samples a ray.
Needs a CUDA card.
"""

import argparse
import time
from collections import defaultdict

import numpy as np
import torch

from . import flagship as F

KERNEL_NAMES = {"K1": "points_mlp", "K3": "sigma_color",
                "K4": "fused_mlp_kernel", "K4 f32": "fused_mlp_tf32_kernel",
                "K5": "fold_fwd_kernel", "K5 backward": "fold_bwd_kernel"}


def _timed(fn):
    """(result, wall ms) of fn() between two device waits."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _train_setup(dev):
    """A trainer at step 20 of bench.py's schedule, its loader's iterator,
    and a line of timings of the march and the refreshes."""
    from .models import make_network
    from .models.renderer import near_far_from_aabb, aabb_of
    from .ops.marching import march_rays
    from .train.trainer import Trainer
    opt = F.train_opt()
    dataset = F.train_dataset(dev, opt=opt)
    net = make_network(F.TRAIN_CFG, None, device=dev, trainable=True,
                       generator=torch.Generator(device=dev).manual_seed(0))
    trainer = Trainer(opt, net, mute=True)
    trainer.start(dataset)
    batches = iter(dataset.dataloader())
    for _ in range(20):
        trainer.iteration(next(batches))
    cfg, st = net.cfg, trainer.renderer_state
    data = next(batches)
    o, d = data["rays_o"][0], data["rays_d"][0]
    nr, fr = near_far_from_aabb(o, d, aabb_of(cfg, dev), cfg.min_near)
    m, march_ms = _timed(lambda: march_rays(
        o, d, nr, fr, st.density_bitfield, cfg.bound, cfg.cascade,
        cfg.grid_size, max_samples=trainer._grid_max_samples(),
        max_steps=opt.max_steps, dt_gamma=opt.dt_gamma,
        perturb=trainer.generator, skip_grid=st.skip_grid,
        samples_per_hit=opt.grid_samples_per_hit))
    step = trainer.global_step
    trainer.global_step = 0                     # a full refresh
    _, full_ms = _timed(trainer._maybe_refresh)
    trainer.global_step = opt.grid_warmup_steps + 16   # a partial one
    _, part_ms = _timed(trainer._maybe_refresh)
    trainer.global_step = step
    info = (f"march of one batch {march_ms:.3f} ms ({m['iters']} "
            f"iterations, {int(m['count'].sum())} samples of "
            f"{m['ts'].shape[1]} slots x {o.shape[0]} rays); full refresh "
            f"{full_ms:.3f} ms, partial {part_ms:.3f} ms")
    return trainer, batches, info


CLI_MODES = {"train_O_ff": ["-O", "--ff"], "train_ff": ["--ff"]}


def _cli_train_setup(dev, flags):
    """The training CLI's trainer for `flags` after 20 steps, its loader's
    iterator, and a line on the run."""
    from .cli import apply_O_flag, build_parser
    from .config import network_config_from_opt
    from .data.provider import NeRFDataset
    from .models import make_network
    from .train.trainer import Trainer
    opt = apply_O_flag(build_parser("train").parse_args(
        ["-", *flags, "--bound", "1", "--scale", "1", "--seed", "0"]),
        "train")
    dataset = NeRFDataset(opt, F.train_splits(), type="train", device=dev)
    net = make_network(network_config_from_opt(opt), None, device=dev,
                       opt=opt, trainable=True,
                       generator=torch.Generator(device=dev).manual_seed(0))
    trainer = Trainer(opt, net, ema_decay=0.95, mute=True)
    trainer.start(dataset)
    batches = iter(dataset.dataloader())
    for _ in range(20):
        trainer.iteration(next(batches))
    return trainer, batches, (f"main_nerf {' '.join(flags)}: "
                              f"{net.cfg.compute_dtype}, grid_ray "
                              f"{net.cfg.grid_ray}, fused {net.cfg.fused}")


def _encode_ms(net, frame):
    """(device ms, calls) of `net.encode_pos` in one frame: CUDA events
    around each call, read after the frame."""
    events = []
    encode = net.encode_pos

    def timed(x):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = encode(x)
        b.record()
        events.append((a, b))
        return out

    net.encode_pos = timed
    frame()
    del net.encode_pos
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events), len(events)


def _frame_profile(mode, dev, acts):
    """(profiled wall ms, unprofiled wall ms, profile, a line on the
    encode or '') of one frame."""
    staged = mode in F.STAGED_MODES
    warm, reps = (1, 2) if staged else (3, 4)
    with torch.inference_mode():
        if F.MODES[mode]["net"].startswith("ref"):
            nets, stored = F.load_ref_nets(dev)
            state = None if staged else F.refresh(nets["ref"], stored)
        else:
            teacher, stored = F.load_teacher_net(dev)
            nets = {"teacher": teacher, **F.load_students(dev)}
            state = F.refresh(teacher, stored)
        o, d = F.pose_rays(F.holdout_poses()[0], dev)

        def frame():
            return F.render(mode, nets, state, o, d)

        for _ in range(warm):
            frame()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            frame()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        info = ""
        if staged:
            enc_ms, calls = _encode_ms(nets[F.MODES[mode]["net"]], frame)
            info = (f"corner hash-grid encode: {enc_ms:.3f} ms of device "
                    f"time in {calls} calls (one a chunk), CUDA "
                    "events around each call of one more frame")
    return wall_ms, plain_wall_ms, prof, info


ROLLOUT_MODES = {f"rollout_{path}": path for path in F.ROLLOUT_NETS}


def _rollout_setup(path, dev):
    """(one step of the rollout path's engine over F.ROLLOUT_SIMS sims, as a
    function; a line timing its parts): the smoke's engine
    (flagship.rollout_engine) cut to one step, over a free-space SDF of the
    smoke's shape (a lookup costs the same)."""
    name = F.ROLLOUT_NETS[path]
    if name == "ref":
        nets, _ = F.load_ref_nets(dev)
        state = None
    else:
        teacher, stored = F.load_teacher_net(dev)
        nets = {"teacher": teacher, **F.load_students(dev)}
        state = F.refresh(teacher, stored)
    sdf = np.ones((80, 80, 80), np.float32)
    eng = F.rollout_engine(path, nets[name], state, sdf, (-1.0, -1.0, -1.0),
                           40, steps=1, device=dev)
    z = torch.randn((F.ROLLOUT_SIMS, 1, 12), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    states = eng.start_state.expand(F.ROLLOUT_SIMS, 12)
    eng.run(z)
    stats, obs_ms = _timed(lambda: eng._render_stats(states[:1]))
    _, all_ms = _timed(lambda: eng._render_stats(states))
    _, uq_ms = _timed(lambda: eng._gaussian_uq_moments(
        *stats.expand(F.ROLLOUT_SIMS, 5).unbind(-1)))
    info = (f"rollout {path} ({name}, {F.ROLLOUT_OBS}^2): one observation "
            f"{obs_ms:.3f} ms, the {F.ROLLOUT_SIMS} sims' {all_ms:.3f} ms, "
            f"the UQ's {eng.uq_iters} Adam steps over them {uq_ms:.3f} ms "
            "(wall, between device waits)")
    return (lambda: eng.run(z)), info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=sorted(F.MODES) + ["train"]
                    + sorted(CLI_MODES) + sorted(ROLLOUT_MODES),
                    default="baked_h160_ak8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs a CUDA device")
    dev = torch.device("cuda", 0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    info, unit, reps = "", "frame", 1
    if args.mode.startswith(("train", "rollout")):
        if args.mode.startswith("rollout"):
            with torch.inference_mode():
                frame, info = _rollout_setup(ROLLOUT_MODES[args.mode], dev)
            unit, reps = "step", 2
        else:
            trainer, batches, info = _train_setup(dev) \
                if args.mode == "train" \
                else _cli_train_setup(dev, CLI_MODES[args.mode])
            unit, reps = "step", 4

            def frame():
                trainer.iteration(next(batches))

        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                frame()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(8):
            frame()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    else:
        wall_ms, plain_wall_ms, prof, info = _frame_profile(args.mode, dev,
                                                            acts)

    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            by_name[ev.name][1] += 1
    busy_ms = sum(t for t, _ in by_name.values()) / reps
    n_kernels = sum(c for _, c in by_name.values()) / reps
    mine = {k: [sum(v[i] for n, v in by_name.items() if tag in n)
                for i in (0, 1)] for k, tag in KERNEL_NAMES.items()}
    name = torch.cuda.get_device_name(0)
    print(f"mode {args.mode}: {unit} wall {wall_ms:.3f} ms under the "
          f"profiler on {name} (mean of {reps}); device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{n_kernels:g} device kernels a {unit}; "
          + ", ".join(f"{k} {t:.3f} ms in {c} launches"
                      for k, (t, c) in mine.items())
          + f" (over {reps}); {plain_wall_ms:.3f} ms a {unit} without the "
          "profiler")
    if info:
        print(info)
    for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t:9.3f} ms {c:5d}x  {n[:100]}")


if __name__ == "__main__":
    main()
