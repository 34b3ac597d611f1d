"""Safety validation of a trained NeRF: the JAX package's root validate.py
(reference validate.py:23-344), with the same flags and envConfig.json.

    python -m nerfsafetyvalidation_tpu_torch.validate <dataset dir> \\
        [--batched_rollouts [--closed_loop]] [flags]

From the working directory it reads envConfig.json and
validation/utils/sdf.npy, and the checkpoint `--ckpt` names under
<workspace>/checkpoints (or a path). It draws a start and a goal
(generate_path, from Python's unseeded `random`, before the seeding, as the
JAX CLI does; `--iter`/`--k` reload results/coordinates.json), loads the
net the flags build (`--ff`: NeRFNetworkFF through kernel K4), reads the
test split's intrinsics, and builds the NerfSimulator. `reset` runs A* on
the density and the planner's `learn_init`; when A* finds no path the
restart loop draws a new path and a new seed (validate.py:313-341).

Without `--batched_rollouts` (the default): the sequential stress tests,
each simulation reset and stepped one MPC step at a time
(NerfSimulator.step: the observation, the online UQ of envConfig's
`uq_method`, Gaussian or Bayesian Laplace, the estimator, the replan, the
SDF check). Monte Carlo appends to
results/collisionValuesBlenderMC_n<N>.csv; the cross-entropy method (10
sims, 5 elite, 5 iterations) to results/collisionValuesCEM_m10melite5k5.csv.
When `blender` is on PATH and envConfig names a blend file, Blender
draws the trajectories at the end.

`--batched_rollouts`: the planner's actions roll out open-loop through
FullBatchedRolloutEngine (the `--batched_obs_render` observation at
`--batched_obs_res`^2: `uniform` with `--num_steps` samples a ray, or
with `--fast_render` through `run_grid`; `fast`, `guided`, `scout`; the
UQ: Gaussian, or with envConfig's Laplace the engine's in-scan Laplace
fits, the reward, the SDF check): Monte Carlo writes
results/collisionValuesBatchedMC_n<N>.csv, the cross-entropy method
results/collisionValuesBatchedCEM_m<M>melite5k5.csv. With
`--closed_loop`: ClosedLoopBatchedEngine (the estimator and the replan
every step, the UQ reward unless `--closed_loop_uq none`: `auto` follows
envConfig's uq_method), writing
results/collisionValuesClosedLoop{MC_n<N>,CEM_m<M>melite5k5}.csv. With
envConfig's BlenderSimulator (no net): the dynamics and SDF core engine.

`--fast_render`: the occupancy grid is refreshed once from the net (a
torch.Generator seeded --seed draws its jitter), and the observation
render (`render_fn`) marches it, `render_grid_staged` over the net's
cell-layout view (`to_cell`); the planner, the estimator, the NeRF camera
and the engines keep the corner layout, and the engines' marched
observations read the grid.

`--r`: the stress test's CSV under results/ is replayed on a
BlenderSimulator (validation/replay.py) on the saved path
(results/coordinates.json), from `--iter` (and for the cross-entropy
method `--k`) on; the step and trajectory confusion matrices go to
results/confusion_matrix_{step,traj}.{png,json}, the tallies to
counts.pkl.

`--tcnn` builds the biased `NeRFNetworkTCNN`, whose MLPs are plain
chains (no kernel): the estimator's Hessian, the Gaussian UQ and the
Laplace fits (its flatpack holds the biases) go through it on every path,
as the JAX CLI's do.

Refused, with a message and a non-zero exit, before anything is loaded:
a uq_method other than the two, `--r
--ff` (the JAX replay's estimator raises ValueError from jax.hessian
through the fused kernel, with no loop around it: a traceback), and
three combinations on which the JAX CLI restarts forever: `--ff` on the
sequential path and `--closed_loop --ff` (the estimator's jax.hessian
through the fused kernel raises ValueError, which the restart loop takes
for a missing path), and `--batched_obs_render fast|guided|scout` without
`--fast_render` (its fallback engine raises ValueError without the
occupancy state).

`main(argv, device)` runs on the CUDA card unless the caller passes
device='cpu'."""

import csv
import os
import random
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
from .nav.camera import CannedCamera, NerfCamera
from .nav.math_utils import vec_to_rot_matrix
from .train.trainer import Trainer
from .utils.seeding import seed_everything
from .validation.batched import BatchedRolloutEngine, FullBatchedRolloutEngine
from .validation.closed_loop import ClosedLoopBatchedEngine
from .validation.distributions import SeedableMultivariateNormal
from .validation.replay import replay_CEM, replay_MC
from .validation.simulators import BlenderSimulator, NerfSimulator
from .validation.stresstests import CrossEntropyMethod, MonteCarlo
from .validation.utils.paths import generate_path, load_coords, save_coords

# samples a batched call renders at most: the open-loop engine's
# observations (obs_group sims a call) and the closed-loop engine's
# population (sim_group sims at a time, their pixels' rays)
OBS_SAMPLES = 2 ** 23
CLOSED_LOOP_SAMPLES = 2 ** 22
GAUSSIAN = "Gaussian Approximation"
LAPLACE = "Bayesian Laplace Approximation"


def refusal(opt, env):
    """Why the port does not run this command line, or None."""
    if env.simulator not in ("NerfSimulator", "BlenderSimulator"):
        return f"Unrecognized simulator {env.simulator}"
    if env.stress_test not in ("Monte Carlo", "Cross Entropy Method"):
        return f"Unrecognized stress test {env.stress_test}"
    if opt.r and opt.ff:
        return ("--r --ff: the replay's estimator takes the Hessian through "
                "the fused MLP, where jax.hessian raises ValueError in the "
                "JAX CLI, which has no loop around the replay and exits with "
                "a traceback; replay without --ff")
    if opt.batched_rollouts and opt.batched_obs_render != "uniform" \
            and not (opt.fast_render or opt.r):
        return (f"--batched_obs_render {opt.batched_obs_render} needs "
                "--fast_render's occupancy state; without it the JAX CLI "
                "falls back to 'scout', whose engine raises ValueError, and "
                "the restart loop retries forever")
    if env.simulator == "NerfSimulator" \
            and env.uq_method not in (GAUSSIAN, LAPLACE):
        return f"Unrecognized uncertainty quantification method " \
               f"{env.uq_method!r}"
    if opt.ff and not opt.batched_rollouts:
        return ("--ff on the sequential path: the estimator's Hessian "
                "through the fused MLP raises ValueError in the JAX CLI, "
                "whose restart loop then retries forever; run it without "
                "--ff")
    if opt.batched_rollouts and opt.closed_loop and opt.ff:
        return ("--closed_loop --ff: the estimator's Hessian through the "
                "fused MLP raises ValueError in the JAX CLI, whose restart "
                "loop then retries forever; run --closed_loop without --ff")
    return None


def _group(per_sim: int, budget: int) -> int:
    return max(1, budget // max(1, per_sim))


def _csv_rows(path, rows):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)


def _engine_args(simulator, noise_mean, noise_std, device):
    a = simulator.agent_cfg
    return dict(dt=a["dt"], g=a["g"], mass=a["mass"],
                I=np.asarray(a["I"], dtype=np.float32), sdf=simulator.sdf,
                sdf_start=[simulator.START_X, simulator.START_Y,
                           simulator.START_Z],
                granularity=simulator.GRANULARITY, noise_mean=noise_mean,
                noise_std=noise_std, start_state=simulator.true_start_state,
                device=device)


def _uq_engine(simulator, actions, noise_mean, noise_std, opt, device,
               uq_method="gaussian"):
    """The open-loop engine over the simulator's net: the
    --batched_obs_render observation at batched_obs_res^2 (`uniform`:
    num_steps samples a ray, or through `run_grid` with --fast_render's
    occupancy state), the UQ `uq_method` ("gaussian" or "laplace") at the
    JAX CLI's knobs (validate.py:114-135)."""
    res = int(opt.batched_obs_res)
    return FullBatchedRolloutEngine(
        actions, net=simulator.net, obs_res=res,
        render_steps=int(opt.num_steps), base_res=simulator.res_x,
        uq_method=uq_method, obs_render=opt.batched_obs_render,
        renderer_state=simulator.renderer_state,
        obs_group=_group(res * res * int(opt.num_steps), OBS_SAMPLES),
        **_engine_args(simulator, noise_mean, noise_std, device))


def validate_batched(simulator, stresstest, noise_mean, noise_std,
                     n_simulations, opt, device="cuda"):
    """The population modes (validate.py:47-151): one reset (A* and
    learn_init), then the planner's actions through the open-loop engine,
    or the closed-loop engine with --closed_loop."""
    uq_method = "gaussian"
    if getattr(simulator, "uq_method", None) == LAPLACE:
        uq_method = "laplace"
        print("[INFO] batched rollouts with in-scan Bayesian-Laplace UQ "
              "(subsampled MAP fits; sequential mode runs the full-set "
              "fits)")
    simulator.reset()
    actions = simulator.traj.get_actions().detach()
    if opt.closed_loop:
        if getattr(simulator, "net", None) is None:
            raise SystemExit("--closed_loop needs the NeRF simulator (the "
                             "estimator's measurement renders the NeRF)")
        return validate_closed_loop(simulator, stresstest, noise_mean,
                                    noise_std, n_simulations, actions, opt,
                                    device)
    gen = torch.Generator(device=device).manual_seed(opt.seed)
    if getattr(simulator, "net", None) is None:
        # no NeRF to render: the dynamics, SDF and likelihood core engine
        print("[WARN] batched rollouts without a NeRF observation model: "
              "running the dynamics+SDF core only")
        eng = BatchedRolloutEngine(
            actions, **_engine_args(simulator, noise_mean, noise_std,
                                    device))
        res = eng.monte_carlo(gen, n_simulations)
        _csv_rows(f"results/collisionValuesBatchedMC_n{n_simulations}.csv",
                  [[i, bool(res["ever_collided"][i]), float(res["risk"][i]),
                    int(res["first_collision_step"][i])]
                   for i in range(n_simulations)])
        return res
    eng = _uq_engine(simulator, actions, noise_mean, noise_std, opt, device,
                     uq_method)
    if stresstest == "Cross Entropy Method":
        m = max(n_simulations, 10)
        res = eng.cem(gen, m=m, m_elite=5, kmax=5,
                      csv_path=f"results/collisionValuesBatchedCEM_m{m}"
                               "melite5k5.csv")
        print(f"Batched CEM history: {res['history']}")
    else:
        res = eng.monte_carlo(gen, n_simulations)
        rate = float(res["collided"].any(axis=1).mean())
        print(f"Batched MC: collision rate {rate:.4f} over "
              f"{n_simulations} rollouts")
        eng.write_mc_csv(
            res, f"results/collisionValuesBatchedMC_n{n_simulations}.csv")
    return res


def validate_closed_loop(simulator, stresstest, noise_mean, noise_std,
                         n_simulations, actions, opt, device="cuda"):
    """The closed-loop population mode (validate.py:154-262): the fixed
    interest grid of closed_loop_obs_res^2 pixels over the observation,
    the estimator and replan settings of envConfig, and unless
    --closed_loop_uq none the composed open-loop engine's UQ reward (auto:
    Laplace where envConfig's uq_method is, else Gaussian)."""
    fc = dict(simulator.filter_cfg)
    traj = simulator.traj
    H, W = simulator.res_y, simulator.res_x
    intr = getattr(simulator, "dataset_intrinsics",
                   (1111.0, 1111.0, W / 2.0, H / 2.0))
    G = max(2, int(opt.closed_loop_obs_res))
    rows = np.linspace(0, H - 1, G).astype(int)
    cols = np.linspace(0, W - 1, G).astype(int)
    rr, cc = np.meshgrid(rows, cols, indexing="ij")
    coords = np.stack([rr.reshape(-1), cc.reshape(-1)], axis=-1)

    uq_flag = opt.closed_loop_uq
    if uq_flag == "auto":
        uq_flag = "laplace" if simulator.uq_method == LAPLACE else "gaussian"
    uq_engine = None
    if uq_flag != "none":
        uq_engine = _uq_engine(simulator, actions, noise_mean, noise_std,
                               opt, device, uq_flag)
        print(f"[INFO] closed-loop steps compute the {uq_flag} "
              "uncertainty-masked reward (complete NerfSimulator.step)")
    pc = simulator.planner_cfg
    eng = ClosedLoopBatchedEngine(
        steps=actions.shape[0], fixed_coords=coords, intrinsics=intr,
        obs_hw=(H, W), render_rays_fn=simulator.render_batch_fn,
        n_iter=int(fc.get("N_iter", 20)), est_lr=float(fc.get("lrate", 1e-3)),
        sig0=fc.get("sig0"), Q=fc.get("Q"), filter=True,
        end_state=simulator.end_state, knots0=traj.states,
        initial_accel0=traj.initial_accel,
        epochs_update=int(pc["epochs_update"]), planner_lr=float(pc["lr"]),
        density_fn=simulator.density_fn, robot_body=traj.robot_body,
        fade_out_epoch=pc["fade_out_epoch"],
        fade_out_sharpness=pc["fade_out_sharpness"], uq_engine=uq_engine,
        sim_group=_group(G * G * int(opt.num_steps), CLOSED_LOOP_SAMPLES),
        **_engine_args(simulator, noise_mean, noise_std, device))
    gen = torch.Generator(device=device).manual_seed(opt.seed)
    if stresstest == "Cross Entropy Method":
        m = max(n_simulations, 10)
        res = eng.cem(gen, m=m, m_elite=5, kmax=5,
                      csv_path=f"results/collisionValuesClosedLoopCEM_m{m}"
                               "melite5k5.csv")
        print(f"Closed-loop CEM history: {res['history']}")
        return res
    res = eng.monte_carlo(gen, n_simulations)
    print(f"Closed-loop batched MC: collision rate "
          f"{res['collision_rate']:.4f} over {n_simulations} rollouts")
    _csv_rows(f"results/collisionValuesClosedLoopMC_n{n_simulations}.csv",
              [[i, bool(res["ever_collided"][i]), float(res["risk"][i])]
               for i in range(n_simulations)])
    return res


def validate(simulator, stresstest, noise_mean, noise_std, n_simulations,
             steps, blend_file, workspace, opt, device="cuda"):
    """validate.py:23-54: the population modes with --batched_rollouts,
    else the sequential stress test; then, when `blender` is on PATH and
    a blend file is named, Blender draws the trajectories. Returns the
    stress test's result (MonteCarlo, or CEM's optimize() tuple)."""
    if opt.batched_rollouts:
        return validate_batched(simulator, stresstest, noise_mean, noise_std,
                                n_simulations, opt, device)
    if stresstest == "Monte Carlo":
        print(f"Starting Monte Carlo test with {n_simulations} simulations "
              f"and {steps} steps each")
        res = MonteCarlo(simulator, n_simulations, steps, noise_mean,
                         noise_std, blend_file, workspace, opt.iter,
                         noise_seed=opt.seed, device=device)
        res.validate()
    else:
        print(f"Starting Cross Entropy Method test with {n_simulations} "
              f"simulations and {steps} steps each")
        mean = np.asarray(noise_mean, np.float32)
        cov = np.diag(np.asarray(noise_std, np.float32) ** 2)
        q = SeedableMultivariateNormal([mean] * steps, [cov] * steps,
                                       noise_seed=opt.seed, device=device)
        p = SeedableMultivariateNormal([mean] * steps, [cov] * steps,
                                       noise_seed=opt.seed, device=device)
        cem = CrossEntropyMethod(simulator, q, p, 10, 5, 5, opt.seed,
                                 blend_file, workspace, opt.iter, opt.k)
        res = cem.optimize()
        means, covs, _, bm, bc, bv = res
        print(f"Means: {means}")
        print(f"Covariance Matrices: {covs}")
        print(f"Best solution means: {bm}")
        print(f"Best solution covariance matrix: {bc}")
        print(f"Best objective value: {bv}")
    # the trajectories drawn in Blender (validate.py:52-53)
    if shutil.which("blender") and blend_file:
        subprocess.run(["blender", blend_file, "-P",
                        "scripts/blender/viz_data_blend.py", "--background",
                        "--", opt.workspace, str(0.02)], check=False)
    return res


def main(argv=None, device="cuda"):
    """Returns the stress test's result (see `validate`), or with --r the
    replay's eight counts (see validation/replay.py)."""
    opt = apply_O_flag(build_parser("validate").parse_args(argv), "validate")
    env = EnvConfig.load("envConfig.json")
    why = refusal(opt, env)
    if why is not None:
        raise SystemExit(f"validate: {why}")
    p = env.planner_cfg
    ranges = (p["x_range"], p["y_range"], p["z_range"])
    if opt.r or opt.iter != 0 or opt.k != 0:
        start_pos, end_pos, steps = load_coords()
    else:
        start_pos, end_pos, steps = generate_path(*ranges)
        save_coords(start_pos, end_pos, steps)
    seed_everything(opt.seed, device)

    net = make_network(network_config_from_opt(opt), None, device=device,
                       opt=opt, trainable=True)
    Trainer(opt, net, name="ngp", workspace=opt.workspace,
            use_checkpoint=opt.ckpt)
    for w in net.param_list():
        w.requires_grad_(False)
    dataset = NeRFDataset(opt, type="test", device=device)  # intrinsics

    agent_cfg = dict(env.agent_cfg)
    dev = torch.device(device)

    def build_states(start_pos, end_pos):
        zeros = torch.zeros(3, device=dev)

        def state(pos, rotvec):
            R = vec_to_rot_matrix(torch.tensor(rotvec, dtype=torch.float32,
                                               device=dev))
            return torch.cat([torch.tensor(pos, dtype=torch.float32,
                                           device=dev), zeros,
                              R.reshape(-1), zeros])
        return state(start_pos, p["start_R"]), state(end_pos, p["end_R"])

    start_state, end_state = build_states(start_pos, end_pos)
    planner_cfg = {
        "x_range": p["x_range"], "y_range": p["y_range"],
        "z_range": p["z_range"], "T_final": p["T_final"], "steps": steps,
        "lr": p["planner_lr"], "epochs_init": p["epochs_init"],
        "fade_out_epoch": p["fade_out_epoch"],
        "fade_out_sharpness": p["fade_out_sharpness"],
        "epochs_update": p["epochs_update"],
        "start_state": start_state, "end_state": end_state,
        # the workspace's base name: "paths" / an absolute workspace would
        # be the workspace itself, which clear_workspace would delete
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
    noise_std = np.asarray(env.mpc_cfg["mpc_noise_std"], dtype=np.float32)
    noise_mean = np.asarray(env.mpc_cfg["mpc_noise_mean"], dtype=np.float32)

    # the Blender -> NeRF axis rotation (validate.py:282-291)
    rot = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                       device=dev)

    def density_fn(x):
        return net.density(x.reshape(-1, 3) @ rot)["sigma"].reshape(
            x.shape[:-1])

    state = None
    if opt.fast_render:
        # the occupancy-marched observation: the grid refreshed once from
        # the net, and a render-only cell-layout view of it
        # (validate.py:397-425)
        print("[INFO] building density grid + cell tables for fast render")
        cfg = net.cfg
        with torch.no_grad():
            state = R.update_extra_state(
                net, R.RendererState.create(cfg.cascade, cfg.grid_size,
                                            device=device),
                generator=torch.Generator(device=dev).manual_seed(opt.seed),
                grid_size=cfg.grid_size)
            render_net = net.to_cell()

        def render_fn(rays_o, rays_d):
            return R.render_grid_staged(
                render_net, state, rays_o, rays_d,
                max_ray_batch=opt.max_ray_batch, max_steps=opt.max_steps,
                dt_gamma=opt.dt_gamma, bg_color=1.0)
    else:
        def render_fn(rays_o, rays_d):
            return R.render(net, rays_o, rays_d, staged=True, bg_color=1.0,
                            num_steps=opt.num_steps,
                            upsample_steps=opt.upsample_steps,
                            max_ray_batch=opt.max_ray_batch)

    def render_batch_fn(rays_o, rays_d):
        return R.render(net, rays_o, rays_d, staged=False, bg_color=1.0,
                        num_steps=opt.num_steps,
                        upsample_steps=opt.upsample_steps)

    def get_rays_fn(pose):
        return get_rays(pose, dataset.intrinsics, dataset.H, dataset.W,
                        device=dev)

    camera = None
    if opt.camera == "canned":
        camera = CannedCamera(res_x=camera_cfg["res_x"],
                              res_y=camera_cfg["res_y"])
    elif opt.camera == "nerf":
        # the staged frame, with or without --fast_render
        # (validate.py:443-451)
        def render_from_pose(pose):
            rays = get_rays_fn(np.asarray(pose, np.float32)[None])
            with torch.no_grad():
                return R.render(net, rays["rays_o"], rays["rays_d"],
                                staged=True, bg_color=1.0,
                                num_steps=opt.num_steps,
                                max_ray_batch=opt.max_ray_batch)["image"]
        camera = NerfCamera(render_from_pose, res_x=camera_cfg["res_x"],
                            res_y=camera_cfg["res_y"])

    sim_args = (start_state, end_state, agent_cfg, planner_cfg, camera_cfg,
                filter_cfg, get_rays_fn, render_fn, blender_cfg, density_fn)
    if env.simulator == "NerfSimulator":
        simulator = NerfSimulator(*sim_args, env.uq_method, net, opt.seed,
                                  camera=camera,
                                  render_batch_fn=render_batch_fn,
                                  device=device)
    else:
        simulator = BlenderSimulator(*sim_args, opt.seed, camera=camera,
                                     render_batch_fn=render_batch_fn,
                                     device=device)
    # the engines' marched observations read --fast_render's grid
    simulator.renderer_state = state
    simulator.dataset_intrinsics = tuple(
        float(v) for v in np.asarray(dataset.intrinsics).reshape(-1)[:4])

    if opt.r:
        # the replay on the ground-truth simulator (validate.py:478-495)
        replay = replay_MC if env.stress_test == "Monte Carlo" \
            else replay_CEM
        args = (start_state, end_state, noise_mean, noise_std, agent_cfg,
                planner_cfg, camera_cfg, filter_cfg, get_rays_fn, render_fn,
                blender_cfg, density_fn, agent_cfg["blend_file"],
                opt.workspace, opt.seed, opt.iter)
        if replay is replay_CEM:
            args += (opt.k,)
        res = replay(*args, camera=camera, device=device)
        print("End of validation".center(20, "."))
        return res

    # the restart loop (validate.py:313-341): A* found no path (ValueError)
    # or the start or goal is occupied (AssertionError)
    while True:
        try:
            res = validate(simulator, env.stress_test, noise_mean,
                           noise_std, env.n_simulations, steps,
                           agent_cfg["blend_file"], opt.workspace, opt,
                           device)
            break
        except (ValueError, AssertionError):
            print("Path not found; restarting with new path...")
            opt.seed += random.randint(0, 10)
            seed_everything(opt.seed, device)
            simulator.seed = opt.seed
            start_pos, end_pos, steps = generate_path(*ranges)
            save_coords(start_pos, end_pos, steps)
            start_state, end_state = build_states(start_pos, end_pos)
            planner_cfg.update(start_state=start_state, end_state=end_state,
                               steps=steps)
            simulator.start_state = start_state
            simulator.end_state = end_state
    print("End of validation".center(20, "."))
    return res


if __name__ == "__main__":
    main()
