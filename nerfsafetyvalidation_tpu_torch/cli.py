"""The entry points' shared flags (nerfsafetyvalidation_tpu/cli.py), with
the same names, defaults and help as the JAX package's CLI, so that one
command line means the same run in either package.

Parity target: the argparse flags duplicated across the reference's
main_nerf.py:10-59, validate.py:59-110, uncertain.py:252-299 and
simulate.py:107-156, including the `-O` meta-flag whose expansion differs by
entry point (train: fp16+cuda_ray+preload, main_nerf.py:61-64; validation/UQ:
fp16, cuda_ray=False, preload=False, validate.py:115-118). `--fp16` selects
bfloat16 compute and `--cuda_ray` the occupancy-grid-marched render path
(grid_ray). The flags' help texts are the JAX package's; the port runs
the paths that its entry points have ported and raises on the others.
"""

import argparse
import random


def build_parser(entry: str = "train") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("-O", action="store_true",
                        help="meta flag (see entry-point expansion)")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int,
                        default=random.randint(0, 99999999))
    if entry == "validate":
        parser.add_argument("--iter", type=int, default=0)
        parser.add_argument("--k", type=int, default=0)
    if entry == "train":
        parser.add_argument("--test", action="store_true")
        parser.add_argument("--iters", type=int, default=30000)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--ckpt", type=str, default="latest")
    parser.add_argument("--num_rays", type=int, default=4096)
    parser.add_argument("--cuda_ray", action="store_true",
                        help="occupancy-grid marched rendering")
    parser.add_argument("--max_steps", type=int, default=1024)
    parser.add_argument("--num_steps", type=int, default=512)
    parser.add_argument("--upsample_steps", type=int, default=0)
    parser.add_argument("--update_extra_interval", type=int, default=16)
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help=">1 fuses that many training steps into one "
                             "dispatch (identical trajectory)")
    parser.add_argument("--max_ray_batch", type=int, default=4096)
    parser.add_argument("--fp16", action="store_true",
                        help="bfloat16 compute")
    parser.add_argument("--ff", action="store_true",
                        help="fused MLP path (kernel K4)")
    parser.add_argument("--tcnn", action="store_true",
                        help="accepted for CLI parity; same fused path")
    parser.add_argument("--encoding", type=str, default="hashgrid",
                        choices=["hashgrid", "tiledgrid", "frequency", "None"],
                        help="position encoding backbone")
    parser.add_argument("--color_space", type=str, default="srgb")
    parser.add_argument("--preload", action="store_true")
    parser.add_argument("--bound", type=float, default=2)
    parser.add_argument("--scale", type=float, default=0.33)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=1 / 128)
    parser.add_argument("--render_mode", type=str, default="staged",
                        choices=["staged", "fast", "guided", "scout"],
                        help="test/video frame renderer: 'staged' is the "
                             "reference-semantics chunked path; 'fast' is "
                             "the marched sorted-shading frame path; "
                             "'guided'/'scout' use the depth-guided "
                             "windowed fine pass (marched or gather-free "
                             "scout prepass)")
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--bg_radius", type=float, default=-1)
    parser.add_argument("--gui", action="store_true")
    parser.add_argument("--W", type=int, default=1920)
    parser.add_argument("--H", type=int, default=1080)
    parser.add_argument("--radius", type=float, default=5)
    parser.add_argument("--fovy", type=float, default=50)
    parser.add_argument("--max_spp", type=int, default=64)
    parser.add_argument("--error_map", action="store_true")
    parser.add_argument("--clip_text", type=str, default="")
    parser.add_argument("--rand_pose", type=int, default=-1)
    if entry == "validate":
        parser.add_argument("--r", action="store_true",
                            help="replay NeRF-run failures on the "
                                 "ground-truth simulator")
    # the JAX package's extensions (not in the reference CLI)
    parser.add_argument("--camera", type=str, default="blender",
                        choices=["blender", "nerf", "canned"],
                        help="observation camera backend (nav/camera.py)")
    parser.add_argument("--fast_render", action="store_true",
                        help="occupancy-marched + cell-table rendering for "
                             "the validation loop's observation renders "
                             "(builds the density grid from the checkpoint)")
    parser.add_argument("--fixed_horizon", action="store_true",
                        help="constant-knot receding-horizon replanning: "
                             "one compiled replan block for the whole "
                             "sweep instead of one compile per horizon "
                             "length")
    parser.add_argument("--batched_obs_res", type=int, default=100,
                        help="observation render resolution inside the "
                             "batched rollout scan")
    parser.add_argument("--batched_rollouts", action="store_true",
                        help="run the batched rollout engine instead of "
                             "the sequential loop")
    parser.add_argument("--batched_obs_render", type=str, default="uniform",
                        choices=["uniform", "fast", "guided", "scout"],
                        help="in-scan observation renderer: 'uniform' "
                             "fixed-step samples; 'fast'/'guided' marched "
                             "frame paths (need --fast_render's occupancy "
                             "state); 'scout' occupancy-masked density-"
                             "scout windows (grid-free fine pass) — the "
                             "large-obs scaling paths")
    parser.add_argument("--closed_loop", action="store_true",
                        help="with --batched_rollouts: run the estimator "
                             "(N_iter Adam pose fit + EKF covariance) and "
                             "the fixed-horizon replan INSIDE the rollout "
                             "scan (validation/closed_loop.py) — the full "
                             "filtered-MPC loop per population member")
    parser.add_argument("--closed_loop_obs_res", type=int, default=32,
                        help="measurement-pixel grid resolution for the "
                             "in-scan estimator (fixed interest mask)")
    parser.add_argument("--closed_loop_uq", type=str, default="auto",
                        choices=["auto", "none", "gaussian", "laplace"],
                        help="with --closed_loop: also compute the "
                             "uncertainty-masked reward per step (the "
                             "reference's complete NerfSimulator.step — "
                             "estimate + replan + UQ reward) by composing "
                             "a FullBatchedRolloutEngine obs chain at "
                             "--batched_obs_res. 'auto' follows "
                             "envConfig's uq_method; 'none' skips the "
                             "reward (risk = plain min-SDF)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard ray batches over all local devices")
    return parser


def apply_O_flag(opt, entry: str):
    """-O expansions (main_nerf.py:61-64 vs validate.py:115-118)."""
    if getattr(opt, "O", False):
        if entry == "train":
            opt.fp16 = True
            opt.cuda_ray = True
            opt.preload = True
        else:
            opt.fp16 = True
            opt.cuda_ray = False
            opt.preload = False
    return opt
