"""The port's bench: the root bench.py's two-scene gate (bench.py:458-888)
on the CUDA card, from the committed assets.

    python3 -m nerfsafetyvalidation_tpu_torch.bench
    BENCH_SCENES=gauntlet python3 -m nerfsafetyvalidation_tpu_torch.bench

For each scene of `BENCH_SCENES` (default "spheres,gauntlet", bench.py:83)
it loads the trained mip-fold teacher (`flagship.scene_assets`) with its
occupancy refreshed 4x, the committed students of width 160, 192 and 256,
and the four held-out poses at 800x800, their ground truth traced
analytically (`data.synthetic.trace_scene`) and composited on white. The
marched frames pad the rays to whole tiles inside the renderer, as
bench.py's `padded` does. Then, in bench.py's order:

  1. the gates: spheres 28 dB for the mean and the min; gauntlet relative
     to its own `fast` score, mean >= min(24, fast mean - 1.5) and min >=
     min(24, fast min - 1.5) (bench.py:712-734);
  2. each mode of `MODE_ORDER` (bench.py's default list) scored on every
     scene (mean and min PSNR over the four poses, memoized), pass or fail;
  3. every passing mode timed as bench.py's `_time_render` times it (3
     warm-up frames, then 5 batches of 4 back-to-back frames cycling the
     poses, one device wait a batch; the median), per scene, and across
     scenes as len(scenes) * rays / sum of the scenes' medians;
  4. the headline: the fastest passing mode, else the mode with the best
     worst-scene mean PSNR, timed anyway;
  5. the reference-backbone line of each scene (`refbb{,_gauntlet}.ckpt`,
     its occupancy refreshed 4x): pose 0 in `ref_backbone` and with levels
     below 8 (`ref_backbone_ml8`), each timed with 1 warm-up frame and 3
     batches of 2.

It prints one JSON line in bench.py's shape (`vs_baseline` is null: the
port has no baseline), with every batch's time, the per-pose PSNRs, the
launches of K1 (by the student's width), K3 and K4 in the run, and the
card's name and power limit from nvidia-smi.

bench.py's other knobs are not ported: resolution, modes, tile, timing
batches, gates and the reference line's level cut are fixed at its
defaults. Unlike bench.py it catches no exception: a kernel or mode that
raises ends the run with a non-zero exit. It trains and distills nothing
and raises if an asset is missing. `main(argv, device)` runs on the CUDA
card unless the caller passes device='cpu'.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from . import flagship as F
from .data.synthetic import camera_rays, trace_scene
from .ops.hopper import fused_mlp, points_mlp, sigma_color

MODE_ORDER = ("baked_h160_ak8", "baked_h160", "baked_h192", "baked",
              "guided", "fast")
# bench.py SCENE_SPECS (:72-82): each scene's absolute bar, and the
# gauntlet's relative one (anchor mode, margin in dB)
GATE_DB = {"spheres": 28.0, "gauntlet": 24.0}
REL_GATE = {"gauntlet": ("fast", 1.5)}
LABELS = {
    "baked": "distilled gather-free student, depth-guided windows",
    "baked_h192": "distilled gather-free student (192x6), depth-guided "
                  "windows",
    "baked_h160": "distilled gather-free student (160x6), depth-guided "
                  "windows",
    "baked_h160_ak8": "distilled gather-free student (160x6), "
                      "depth-guided windows, adaptive per-tile K 8/16",
    "guided": "mip-fold NGP, depth-guided windowed fine pass",
    "fast": "mip-fold NGP, occupancy-marched sorted shading",
}
RES = F.RES
TIMING = dict(warmup_frames=3, batches=5, batch=4)
REF_TIMING = dict(warmup_frames=1, batches=3, batch=2)


def bench_scenes():
    names = [s for s in os.environ.get("BENCH_SCENES",
                                       "spheres,gauntlet").split(",") if s]
    for s in names:
        if s not in F.SCENES:
            raise ValueError(f"BENCH_SCENES: {s!r} is not one of "
                             f"{F.SCENES}")
    return names


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def psnr_of(img, gt):
    """PSNR of a frame [H*W, 3] against the ground truth [H, W, 3]."""
    pred = img.float().cpu().numpy().reshape(gt.shape)
    mse = float(np.mean((pred - gt) ** 2))
    return -10.0 * np.log10(max(mse, 1e-10))


def time_render(render, views, sync, warmup_frames=3, batches=5, batch=4):
    """bench.py's `_time_render` (:434-455): `warmup_frames` frames, each
    waited for, then `batches` batches of `batch` back-to-back frames
    cycling the views, one `sync()` a batch. Returns (the median seconds a
    frame, each batch's seconds a frame)."""
    for i in range(warmup_frames):
        render(*views[i % len(views)][:2])
        sync()
    ts = []
    k = 0
    for _ in range(batches):
        t0 = time.perf_counter()
        for i in range(batch):
            render(*views[(k + i) % len(views)][:2])
        k += batch
        sync()
        ts.append((time.perf_counter() - t0) / batch)
    return float(np.median(ts)), ts


def aggregate(dts, n_rays):
    """The cross-scene rays/s of per-scene median seconds a frame
    (bench.py:760-766)."""
    return len(dts) * n_rays / sum(dts)


def scene_gates(scene, anchor=None):
    """bench.py's bars of a scene (:712-734). `anchor` is the relative
    anchor mode's (mean, min) PSNR on the scene, for a relative scene."""
    bar = GATE_DB[scene]
    gates = {"gate_db": bar, "gate_min_db": bar}
    if scene in REL_GATE:
        margin = REL_GATE[scene][1]
        mean, low = anchor
        gates.update(gate_db=min(bar, mean - margin),
                     gate_min_db=min(bar, low - margin),
                     anchor_db=round(mean, 2), anchor_min_db=round(low, 2))
    return gates


def gate_modes(names, scenes, gates, score, time_mode, n_rays):
    """bench.py's mode loop and headline (:736-795). score(name, scene) ->
    (mean, min, per-pose PSNRs); time_mode(name, scene) -> (median seconds
    a frame, each batch's). Returns (modes, headline name, its rays/s)."""
    modes, passing = {}, []

    def timed(name, entry):
        dts = []
        for scene in scenes:
            dt, batch_s = time_mode(name, scene)
            dts.append(dt)
            entry[scene].update(rays_per_s=round(n_rays / dt),
                                s_per_frame=dt, batch_s=batch_s)
        agg = aggregate(dts, n_rays)
        entry["rays_per_s"] = round(agg)
        return agg

    for name in names:
        entry, ok = {}, True
        for scene in scenes:
            mean, low, poses = score(name, scene)
            entry[scene] = {"psnr_mean": round(mean, 2),
                            "psnr_min": round(low, 2), "psnr_poses": poses}
            ok &= (mean >= gates[scene]["gate_db"]
                   and low >= gates[scene]["gate_min_db"])
        entry["pass"] = ok
        modes[name] = entry
        if ok:
            passing.append((name, timed(name, entry)))
    if passing:
        name, rays_per_s = max(passing, key=lambda x: x[1])
    else:
        # nothing cleared every gate: the best worst-scene mean, timed
        name = max(modes, key=lambda m: min(modes[m][s]["psnr_mean"]
                                            for s in scenes))
        rays_per_s = timed(name, modes[name])
    return modes, name, rays_per_s


def result_line(scenes, gates, modes, name, rays_per_s, ref, launches,
                device):
    """The JSON object bench.py prints (:862-888), with the port's
    additions: the kernels' launches in the run and the card."""
    pose_means = [modes[name][s]["psnr_mean"] for s in scenes]
    pose_mins = [modes[name][s]["psnr_min"] for s in scenes]
    return {
        "metric": f"rays/sec/chip ({RES}^2 held-out render, trained scenes "
                  f"[{'+'.join(scenes)}], {LABELS[name]}, bf16)",
        "value": round(rays_per_s),
        "unit": "rays/s",
        "vs_baseline": None,
        "psnr_db": round(float(np.mean(pose_means)), 2),
        "psnr_mean": round(float(np.mean(pose_means)), 2),
        "psnr_min": round(float(np.min(pose_mins)), 2),
        "mode": name,
        "gate_pass": bool(modes[name]["pass"]),
        "scenes": list(scenes),
        "gates": {s: {k: (round(v, 2) if k.startswith("gate") else v)
                      for k, v in gates[s].items()} for s in scenes},
        "modes": modes,
        "ref_backbone": ref,
        "launches": launches,
        "device": device,
    }


def launch_counts():
    return {"K1": dict(points_mlp.LAUNCHES_BY_WIDTH),
            "K3": sigma_color.LAUNCHES, "K4": fused_mlp.LAUNCHES,
            "K4 f32": fused_mlp.LAUNCHES_F32}


def _since(before, after):
    k1 = {str(h): n - before["K1"].get(h, 0)
          for h, n in sorted(after["K1"].items())}
    out = {k: after[k] - before[k] for k in after if k != "K1"}
    return {"K1": {h: n for h, n in k1.items() if n}, **out}


def scene_views(scene, device, res):
    """[(rays_o, rays_d [res^2, 3] on the device, ground truth [res, res,
    3] on white)] of the held-out poses: the truth traced in the raw world
    frame, the rays from the pose in the model's frame (bench.py:509-521)."""
    views = []
    for pose in F.holdout_poses():
        o, d = camera_rays(pose, F.intrinsics(res), res, res)
        rgb, alpha, _ = trace_scene(o, d, scene=scene)
        gt = rgb * alpha[..., None] + (1.0 - alpha[..., None])
        views.append((*F.pose_rays(pose, device, res), gt))
    return views


def main(argv=None, device="cuda"):
    """Runs the bench; prints its JSON line and returns it as a dict."""
    argparse.ArgumentParser(
        description="bench.py's two-scene gate on the card "
                    "(scenes: BENCH_SCENES)").parse_args(argv)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    names = bench_scenes()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    before = launch_counts()
    n_rays = RES * RES
    with torch.inference_mode():
        scenes = {}
        for scene in names:
            teacher, stored = F.load_teacher_net(dev, scene)
            scenes[scene] = dict(
                nets={"teacher": teacher, **F.load_students(dev, scene)},
                state=F.refresh(teacher, stored),
                views=scene_views(scene, dev, RES))

        def renderer(name, scene):
            sc = scenes[scene]
            return lambda o, d: F.render(name, sc["nets"], sc["state"], o,
                                         d, RES)["image"]

        memo = {}

        def score(name, scene):
            if (name, scene) not in memo:
                render = renderer(name, scene)
                psnrs = [psnr_of(render(o, d), gt)
                         for o, d, gt in scenes[scene]["views"]]
                memo[name, scene] = (float(np.mean(psnrs)),
                                     float(np.min(psnrs)), psnrs)
            return memo[name, scene]

        def time_mode(name, scene):
            return time_render(renderer(name, scene),
                               scenes[scene]["views"], sync, **TIMING)

        gates = {s: scene_gates(s, score(REL_GATE[s][0], s)[:2]
                                if s in REL_GATE else None) for s in names}
        modes, name, rays_per_s = gate_modes(MODE_ORDER, names, gates, score,
                                             time_mode, n_rays)

        def ref_line(scene):
            nets, stored = F.load_ref_nets(dev, scene)
            state = F.refresh(nets["ref"], stored)
            views = scenes[scene]["views"]
            line = {}
            for mode in ("ref_backbone", "ref_backbone_ml8"):
                def render(o, d, mode=mode):
                    return F.render(mode, nets, state, o, d, RES)["image"]
                o, d, gt = views[0]
                p = psnr_of(render(o, d), gt)
                dt, batch_s = time_render(render, views, sync, **REF_TIMING)
                part = {"psnr_db": round(p, 2), "psnr": p,
                        "rays_per_s": round(n_rays / dt),
                        "s_per_frame": dt, "batch_s": batch_s}
                if mode == "ref_backbone":
                    line.update(part)
                else:
                    line["masked"] = {"max_level": F.REF_MAX_LEVEL, **part}
            return line

        # spheres keeps bench.py's top-level keys, other scenes nest
        first = "spheres" if "spheres" in names else names[0]
        ref = ref_line(first)
        for scene in names:
            if scene != first:
                ref[scene] = ref_line(scene)
        sync()

    out = result_line(names, gates, modes, name, rays_per_s, ref,
                      _since(before, launch_counts()),
                      card() if dev.type == "cuda" else None)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
