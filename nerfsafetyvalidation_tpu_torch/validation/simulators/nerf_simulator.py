"""The NeRF-surrogate simulator (nerfsafetyvalidation_tpu/validation/
simulators/nerf_simulator.py; reference NerfSimulator.py): the start and
goal, the agent, the SDF grid with its fixed extents (NerfSimulator.py:
55-62), the safety-masked reward, and `reset`, which builds the agent and
the planner, runs A* and `learn_init`, and caches the initial plan's pose
files: when paths/<exp>/init_poses/0.json existed before the reset,
`learn_init` is skipped, the cached files are copied back, and the
planner keeps its A* knots (the reference's quirk, kept).

`step` is one sequential MPC step (NerfSimulator.py:66-155): the planner's
next action through the disturbed dynamics, the observation rendered at
the true pose, the online Gaussian UQ on a second render of it, the
estimator's fit and posterior, the replan from the estimate, and the SDF
check at the last 4 of the states interpolated over the run so far."""

import os
import pathlib
import shutil

import numpy as np
import torch

from ...nav.agent import Agent
from ...nav.estimator import Estimator
from ...nav.math_utils import as_f32, rot_matrix_to_vec, vec_to_rot_matrix
from ...nav.planner import Planner
from ...uq.orchestrator import uncertainty
from ...utils.seeding import seed_everything
from ..utils.blender import worldToIndex
from ..utils.files import cache_poses, restore_poses
from .base import Env, disturbance_action_space, rgb_observation_space


class NerfSimulator(Env):
    """Arguments as the JAX package's (its `get_rays_fn`, `render_fn`,
    `render_batch_fn` and `density_fn` are tensor functions here); `net`
    is the port's field, which holds its weights (the JAX `params` has no
    counterpart); every tensor lives on `device`."""

    def __init__(self, start_state, end_state, agent_cfg, planner_cfg,
                 camera_cfg, filter_cfg, get_rays_fn, render_fn, blender_cfg,
                 density_fn, uq_method, net, seed, camera=None,
                 sdf_path="validation/utils/sdf.npy", sdf=None,
                 uq_kwargs=None, render_batch_fn=None, device="cuda"):
        super().__init__()
        self.device = dev = torch.device(device)
        self.action_space = disturbance_action_space()
        self.observation_space = rgb_observation_space(
            camera_cfg.get("res_y", 800), camera_cfg.get("res_x", 800))
        self.planner_cfg = planner_cfg
        self.start_state = as_f32(start_state, dev)
        self.end_state = as_f32(end_state, dev)
        self.density_fn = density_fn
        self.camera_cfg = camera_cfg
        self.filter_cfg = filter_cfg
        self.blender_cfg = blender_cfg
        self.get_rays_fn = get_rays_fn
        self.render_fn = render_fn
        self.render_batch_fn = render_batch_fn
        self.uq_method = uq_method
        self.uq_kwargs = uq_kwargs or {}
        self.net = net
        self.camera = camera

        # the 18-state (rotation matrix) start as the agent's 12-state
        # (rotation vector) (NerfSimulator.py:40-44)
        agent_cfg = dict(agent_cfg)
        s = self.start_state
        agent_cfg["x0"] = torch.cat([s[:6],
                                     rot_matrix_to_vec(s[6:15].reshape(3, 3)),
                                     s[15:]])
        agent_cfg["dt"] = planner_cfg["T_final"] / planner_cfg["steps"]
        self.agent_cfg = agent_cfg
        self.true_start_state = agent_cfg["x0"]
        self.true_states = self.true_start_state.cpu().numpy()[None]
        self.current_state = None
        self.dynamics = None
        self.filter = None
        self.traj = None
        self.steps = 0
        self.iter = 0

        # the collision grid (NerfSimulator.py:55-62)
        self.GRANULARITY = 40
        self.START_X, self.END_X = -1.4, 1.0
        self.START_Y, self.END_Y = -1.3, 1.0
        self.START_Z, self.END_Z = -0.1, 0.5
        if sdf is not None:
            self.sdf = np.asarray(sdf)
        elif os.path.exists(sdf_path):
            self.sdf = np.load(sdf_path)
        else:
            raise FileNotFoundError(
                f"SDF grid not found at {sdf_path}; build one with "
                "validation.utils.sdf.build_sdf")
        self.seed = seed
        self.res_x = camera_cfg.get("res_x", 800)
        self.res_y = camera_cfg.get("res_y", 800)

    def step(self, disturbance, num_interpolated_points: int = 4):
        """One validated MPC step (NerfSimulator.py:66-155); disturbance
        [12]. Returns (collided, collisionVal, position [3], sigma,
        trace): with the Gaussian UQ, sigma is sigma_d and trace mu_d."""
        action = self.traj.get_next_action().detach()

        true_pose, true_state, gt_img = self.dynamics.step(
            action, noise=as_f32(disturbance, self.device))
        self.current_state = true_state
        self.true_states = np.vstack((self.true_states, true_state))

        # linear interpolation on the states (NerfSimulator.py:93-98)
        x = np.arange(self.true_states.shape[0])
        xnew = np.linspace(x.min(), x.max(),
                           self.true_states.shape[0] * num_interpolated_points)
        interp = np.empty((xnew.shape[0], self.true_states.shape[1]))
        for i in range(self.true_states.shape[1]):
            interp[:, i] = np.interp(xnew, x, self.true_states[:, i])

        nerf_image = self.filter.render_from_pose(true_pose)
        nerf_image = nerf_image.cpu().numpy().reshape(self.res_y, self.res_x,
                                                      -1)
        nerf_image_u8 = (nerf_image * 255).astype(np.uint8)

        # the online uncertainty (NerfSimulator.py:110)
        trace, sigma = uncertainty(
            self.uq_method,
            rendered_output=self.filter.render_for_uncertainty(true_pose),
            net=self.net, lr=self.filter.lrate, H=self.res_y, W=self.res_x,
            **self.uq_kwargs)

        os.makedirs("./sim_img_cache", exist_ok=True)
        try:
            import matplotlib.image
            matplotlib.image.imsave("./sim_img_cache/blenderRender.png",
                                    np.asarray(gt_img))
            matplotlib.image.imsave("./sim_img_cache/NeRFRender.png",
                                    nerf_image_u8)
        except Exception:
            pass

        state_est = self.filter.estimate_state(nerf_image_u8, true_pose,
                                               action)
        state_est = torch.cat([state_est[:6],
                               vec_to_rot_matrix(state_est[6:9]).reshape(-1),
                               state_est[9:]])
        self.traj.update_state(state_est)
        self.traj.learn_update(self.iter)

        collided, collisionVal, current_state = self._sdf_check(
            interp[-num_interpolated_points:])
        if not collided:
            self.iter += 1
        return collided, collisionVal, current_state[:3], sigma, trace

    def _sdf_check(self, states):
        """The SDF at each interpolated state [k, 12] in turn until one
        collides (below 1 / GRANULARITY); a state off the grid is printed
        and does not collide (NerfSimulator.py:131-155). Returns
        (collided, the last SDF value read (9999 if none), the state)."""
        collisionVal = 9999
        collided = False
        for current_state in states:
            try:
                xi = worldToIndex(current_state[0], self.START_X,
                                  self.GRANULARITY)
                yi = worldToIndex(current_state[1], self.START_Y,
                                  self.GRANULARITY)
                zi = worldToIndex(current_state[2], self.START_Z,
                                  self.GRANULARITY)
                if xi < 0 or yi < 0 or zi < 0:
                    raise IndexError
                collisionVal = self.sdf[xi, yi, zi]
                collided = collisionVal < (1 / self.GRANULARITY)
            except IndexError:
                print(f"We are out of bounds with current state "
                      f"{current_state}")
                collided = False
            if collided:
                print(f"Drone collided in state {current_state}")
                break
        return collided, collisionVal, current_state

    def reward(self, likelihood, sigma_d_opt, trace=None):
        """Safety-masked reward (NerfSimulator.py:159-181)."""
        penalty_strength = 36.0
        num_perturbations = 3
        if self.uq_method == "Gaussian Approximation":
            return np.clip(likelihood - penalty_strength * sigma_d_opt,
                           -penalty_strength * 2, penalty_strength)
        if self.uq_method == "Bayesian Laplace Approximation":
            return np.clip(
                likelihood - penalty_strength * sigma_d_opt * trace
                * num_perturbations, -penalty_strength * 2, penalty_strength)
        raise ValueError(f"unknown uq_method {self.uq_method}")

    def reset(self):
        """NerfSimulator.py:183-223: a fresh workspace, numpy and torch
        seeded, the agent, the estimator and the planner built, A* (raises ValueError or
        AssertionError when there is no path), then `learn_init` and the
        pose cache, or, when the cache existed, the cached files copied back
        and the A* knots kept."""
        self.basefolder = "paths" / pathlib.Path(self.planner_cfg["exp_name"])
        cache_flag = os.path.exists(
            self.basefolder / pathlib.Path("init_poses") / "0.json")
        self.clear_workspace()
        seed_everything(self.seed)
        self.iter = 0
        self.true_states = self.true_start_state.cpu().numpy()[None]

        self.dynamics = Agent(self.agent_cfg, self.camera_cfg,
                              self.blender_cfg, camera=self.camera,
                              device=self.device)
        self.filter = Estimator(self.filter_cfg, self.dynamics,
                                self.true_start_state,
                                get_rays_fn=self.get_rays_fn,
                                render_fn=self.render_fn,
                                render_batch_fn=self.render_batch_fn,
                                device=self.device)
        traj = Planner(self.start_state, self.end_state, self.planner_cfg,
                       self.density_fn, device=self.device)
        traj.basefolder = self.basefolder
        self.filter.basefolder = self.basefolder

        traj.a_star_init()

        exp = pathlib.Path(self.planner_cfg["exp_name"])
        if not cache_flag:
            traj.learn_init()
            cache_poses("paths" / exp / "init_poses",
                        "paths" / exp / "init_costs", "cached" / exp)
        else:
            restore_poses("cached" / exp / "poses", "cached" / exp / "costs",
                          "paths" / exp)
        self.traj = traj
        self.steps = int(traj.get_actions().shape[0])

    def clear_workspace(self):
        """NerfSimulator.py:226-248."""
        if self.basefolder.exists():
            shutil.rmtree(self.basefolder)
        self.basefolder.mkdir(parents=True)
        for sub in ("init_poses", "init_costs", "replan_poses",
                    "replan_costs", "estimator_data"):
            (self.basefolder / sub).mkdir()
        sim_img_cache = pathlib.Path(self.agent_cfg.get("path",
                                                        "./sim_img_cache"))
        if sim_img_cache.exists():
            shutil.rmtree(sim_img_cache)
        sim_img_cache.mkdir(parents=True)
