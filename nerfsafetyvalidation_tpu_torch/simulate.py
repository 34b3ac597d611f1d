"""One NeRF-navigation MPC run (the JAX package's root simulate.py;
reference simulate.py:17-100): A* and `learn_init` from envConfig's start
to its goal, then per step the planner's action (the plan's own actions,
open loop, for the last 5 steps) through the dynamics under MPC noise, the
camera's observation, the estimator, and (before the last 5 steps) the
horizon shift and the replan. At the end, when `blender` is on PATH and
envConfig names a blend file, Blender draws the trajectory.

    python -m nerfsafetyvalidation_tpu_torch.simulate <dataset dir> \\
        --camera nerf|canned [flags]

It reads envConfig.json from the working directory and the checkpoint
`--ckpt` names under <workspace>/checkpoints, as validate does, and
writes paths/<workspace name>/ (the plan's and the estimator's JSON). The
JAX script's main() stops before its loop (it uses `os` without importing
it, simulate.py:131, and gives its Agent no `dt`); the port runs it with
the step length T_final / steps that the simulators use.
`main(argv, device)` runs on the CUDA card unless the caller passes
device='cpu'; `--ff` is refused as validate refuses it on its sequential
path (the JAX estimator's Hessian through the fused kernel raises)."""

import os
import pathlib
import shutil
import subprocess

import numpy as np
import torch

from .cli import apply_O_flag, build_parser
from .config import EnvConfig, network_config_from_opt
from .data.provider import NeRFDataset
from .data.rays import get_rays
from .models import make_network
from .models import renderer as R
from .nav.agent import Agent
from .nav.camera import CannedCamera, NerfCamera
from .nav.estimator import Estimator
from .nav.math_utils import as_f32, rot_matrix_to_vec, vec_to_rot_matrix
from .nav.planner import Planner
from .train.trainer import Trainer
from .utils.seeding import seed_everything


def simulate(planner_cfg, agent_cfg, camera_cfg, blender_cfg, filter_cfg,
             extra_cfg, density_fn, render_fn, get_rays_fn, camera=None,
             seed=0, interactive=True, device="cuda"):
    """simulate.py:17-100. Returns the true states [steps + 1, 12] (numpy).
    The MPC noise is drawn from a torch.Generator on `device` seeded
    `seed` (the JAX script splits a threefry key a step)."""
    dev = torch.device(device)
    start_state = as_f32(planner_cfg["start_state"], dev)
    end_state = as_f32(planner_cfg["end_state"], dev)

    basefolder = "paths" / pathlib.Path(planner_cfg["exp_name"])
    if basefolder.exists():
        print(basefolder, "already exists!")
        clear = "y"
        if interactive:
            clear = input("Clear it before continuing? [y/N]:").lower()
        if clear == "y":
            shutil.rmtree(basefolder)
    basefolder.mkdir(parents=True, exist_ok=True)
    for sub in ("init_poses", "init_costs", "replan_poses", "replan_costs",
                "estimator_data"):
        (basefolder / sub).mkdir(exist_ok=True)
    print("created", basefolder)

    traj = Planner(start_state, end_state, planner_cfg, density_fn,
                   device=dev)
    traj.basefolder = basefolder
    traj.a_star_init()
    traj.learn_init()

    start12 = torch.cat([start_state[:6],
                         rot_matrix_to_vec(start_state[6:15].reshape(3, 3)),
                         start_state[15:]])
    agent_cfg = dict(agent_cfg, x0=start12)
    agent = Agent(agent_cfg, camera_cfg, blender_cfg, camera=camera,
                  device=dev)
    filter = Estimator(filter_cfg, agent, start12, get_rays_fn=get_rays_fn,
                       render_fn=render_fn,
                       render_batch_fn=extra_cfg.get("render_batch_fn"),
                       device=dev)
    filter.basefolder = basefolder

    true_states = start12.cpu().numpy()
    steps = int(traj.get_actions().shape[0])
    noise_std = as_f32(extra_cfg["mpc_noise_std"], dev)
    noise_mean = as_f32(extra_cfg["mpc_noise_mean"], dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    for it in range(steps):
        if it < steps - 5:
            action = traj.get_next_action()
        else:
            action = traj.get_actions()[it - steps + 5, :]
        action = action.detach()

        noise = noise_mean + noise_std * torch.randn(
            noise_mean.shape, generator=gen, device=dev)
        true_pose, true_state, gt_img = agent.step(action, noise=noise)
        true_states = np.vstack((true_states, true_state))

        state_est = filter.estimate_state(np.asarray(gt_img)[..., :3],
                                          true_pose, action)
        if it < steps - 5:
            state_est = torch.cat([
                state_est[:6], vec_to_rot_matrix(state_est[6:9]).reshape(-1),
                state_est[9:]])
            traj.update_state(state_est)
            traj.learn_update(it)
    return true_states


def main(argv=None, device="cuda"):
    """Returns the true states (see `simulate`)."""
    opt = apply_O_flag(build_parser("simulate").parse_args(argv),
                       "simulate")
    if opt.ff:
        raise SystemExit(
            "simulate: --ff: the estimator's Hessian through the fused MLP "
            "raises ValueError in the JAX package; run it without --ff")
    env = EnvConfig.load("envConfig.json")
    seed_everything(opt.seed, device)
    dev = torch.device(device)

    net = make_network(network_config_from_opt(opt), None, device=device,
                       opt=opt, trainable=True)
    Trainer(opt, net, name="ngp", workspace=opt.workspace,
            use_checkpoint=opt.ckpt)
    for w in net.param_list():
        w.requires_grad_(False)
    dataset = NeRFDataset(opt, type="test", device=device)  # intrinsics

    pcfg = env.planner_cfg
    # the step length, as the simulators set it (nerf_simulator.py:63 in
    # both packages); the JAX script's main() leaves it out, and its Agent
    # then raises KeyError
    agent_cfg = dict(env.agent_cfg, dt=pcfg["T_final"] / pcfg["steps"])
    zeros = torch.zeros(3, device=dev)

    def state(pos, rotvec):
        R_ = vec_to_rot_matrix(as_f32(rotvec, dev))
        return torch.cat([as_f32(pos, dev), zeros, R_.reshape(-1), zeros])

    planner_cfg = {
        "T_final": pcfg["T_final"], "steps": pcfg["steps"],
        "lr": pcfg["planner_lr"], "epochs_init": pcfg["epochs_init"],
        "fade_out_epoch": pcfg["fade_out_epoch"],
        "fade_out_sharpness": pcfg["fade_out_sharpness"],
        "epochs_update": pcfg["epochs_update"],
        "start_state": state(pcfg["start_pos"], pcfg["start_R"]),
        "end_state": state(pcfg["end_pos"], pcfg["end_R"]),
        # the workspace's base name: "paths" / an absolute workspace would
        # be the workspace itself
        "exp_name": os.path.basename(os.path.normpath(opt.workspace)),
        "fixed_horizon": opt.fixed_horizon,
        "I": agent_cfg["I"], "g": agent_cfg["g"], "mass": agent_cfg["mass"],
        "body": np.asarray(agent_cfg["body_lims"]),
        "nbins": agent_cfg["body_nbins"]}
    camera_cfg = dict(env.camera_cfg, path=agent_cfg["path"])
    blender_cfg = {"blend_path": agent_cfg["blend_file"],
                   "script_path": "scripts/blender/viz_func.py"}
    filter_cfg = dict(env.estimator_cfg, sig0=np.eye(12, dtype=np.float32),
                      Q=np.eye(12, dtype=np.float32))

    def render_batch_fn(ro, rd):
        return R.render(net, ro, rd, staged=False, bg_color=1.0,
                        num_steps=opt.num_steps,
                        upsample_steps=opt.upsample_steps)

    extra_cfg = {"mpc_noise_std": env.mpc_cfg["mpc_noise_std"],
                 "mpc_noise_mean": env.mpc_cfg["mpc_noise_mean"],
                 "render_batch_fn": render_batch_fn}

    # the Blender -> NeRF axis rotation
    rot = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                       device=dev)

    def density_fn(x):
        return net.density(x.reshape(-1, 3) @ rot)["sigma"].reshape(
            x.shape[:-1])

    def render_fn(ro, rd):
        return R.render(net, ro, rd, staged=True, bg_color=1.0,
                        num_steps=opt.num_steps,
                        upsample_steps=opt.upsample_steps,
                        max_ray_batch=opt.max_ray_batch)

    def get_rays_fn(pose):
        return get_rays(pose, dataset.intrinsics, dataset.H, dataset.W,
                        device=dev)

    camera = None
    if opt.camera == "canned":
        camera = CannedCamera(res_x=camera_cfg["res_x"],
                              res_y=camera_cfg["res_y"])
    elif opt.camera == "nerf":
        def render_from_pose(pose):
            rays = get_rays_fn(np.asarray(pose, np.float32)[None])
            with torch.no_grad():
                return R.render(net, rays["rays_o"], rays["rays_d"],
                                staged=True, bg_color=1.0,
                                num_steps=opt.num_steps,
                                max_ray_batch=opt.max_ray_batch)["image"]
        camera = NerfCamera(render_from_pose, res_x=camera_cfg["res_x"],
                            res_y=camera_cfg["res_y"])

    true_states = simulate(planner_cfg, agent_cfg, camera_cfg, blender_cfg,
                           filter_cfg, extra_cfg, density_fn, render_fn,
                           get_rays_fn, camera=camera, seed=opt.seed,
                           interactive=False, device=device)

    if agent_cfg["blend_file"] and shutil.which("blender"):
        subprocess.run(["blender", agent_cfg["blend_file"], "-P",
                        "scripts/blender/viz_data_blend.py",
                        "--background", "--", opt.workspace, "0.02"],
                       check=False)
    return true_states


if __name__ == "__main__":
    main()
