"""The simulators' action and observation spaces (nerfsafetyvalidation_tpu/
validation/simulators/base.py). The reference subclasses gym.Env for these
Box declarations only; the port keeps the attributes in its own `Box` and
`Env`, without gymnasium.

`PlannedEnv` holds what the NeRF simulator and the Blender simulator share
(the two JAX modules write it out twice): the start and goal, the agent's
configuration, the SDF grid with its fixed extents, the interpolated
states, the replan from an estimate, the SDF check, and `reset`, which
builds the agent, the estimator and the planner, runs A* and `learn_init`,
and caches the initial plan's pose files: when paths/<exp>/init_poses/
0.json existed before the reset, `learn_init` is skipped, the cached files
are copied back, and the planner keeps its A* knots (the reference's
quirk, kept)."""

import os
import pathlib
import shutil

import numpy as np
import torch

from ...nav.agent import Agent
from ...nav.estimator import Estimator
from ...nav.math_utils import as_f32, rot_matrix_to_vec, vec_to_rot_matrix
from ...nav.planner import Planner
from ...utils.seeding import seed_everything
from ..utils.blender import worldToIndex
from ..utils.files import cache_poses, restore_poses


class Box:
    def __init__(self, low, high, shape, dtype):
        self.low, self.high, self.shape, self.dtype = low, high, shape, dtype


class Env:
    pass


def disturbance_action_space():
    return Box(low=-np.inf, high=np.inf, shape=(12,), dtype=np.float32)


def rgb_observation_space(h=800, w=800):
    return Box(low=0, high=255, shape=(h, w, 3), dtype=np.uint8)


class PlannedEnv(Env):
    """Arguments as the JAX simulators' (the tensor closures
    `get_rays_fn`, `render_fn`, `render_batch_fn`, `density_fn`); every
    tensor lives on `device`."""

    def __init__(self, start_state, end_state, agent_cfg, planner_cfg,
                 camera_cfg, filter_cfg, get_rays_fn, render_fn, blender_cfg,
                 density_fn, seed, camera=None,
                 sdf_path="validation/utils/sdf.npy", sdf=None,
                 render_batch_fn=None, device="cuda"):
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
        self.dynamics = None
        self.filter = None
        self.traj = None
        self.steps = 0
        self.iter = 0

        # the collision grid (NerfSimulator.py:55-62)
        self.GRANULARITY = 40
        self.START_X, self.START_Y, self.START_Z = -1.4, -1.3, -0.1
        if sdf is not None:
            self.sdf = np.asarray(sdf)
        elif os.path.exists(sdf_path):
            self.sdf = np.load(sdf_path)
        else:
            raise FileNotFoundError(
                f"SDF grid not found at {sdf_path}; build one with "
                "validation.utils.sdf.build_sdf")
        self.seed = seed

    def _record_state(self, true_state, num_interpolated_points):
        """Appends the step's true state; returns the states so far
        linearly interpolated, num_interpolated_points a state
        (NerfSimulator.py:93-98)."""
        self.true_states = np.vstack((self.true_states, true_state))
        x = np.arange(self.true_states.shape[0])
        xnew = np.linspace(x.min(), x.max(),
                           self.true_states.shape[0] * num_interpolated_points)
        interp = np.empty((xnew.shape[0], self.true_states.shape[1]))
        for i in range(self.true_states.shape[1]):
            interp[:, i] = np.interp(xnew, x, self.true_states[:, i])
        return interp

    def _replan(self, state_est):
        """The planner from the estimate [12] (its rotation vector made a
        matrix), then its replan epochs."""
        self.traj.update_state(torch.cat([
            state_est[:6], vec_to_rot_matrix(state_est[6:9]).reshape(-1),
            state_est[9:]]))
        self.traj.learn_update(self.iter)

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

    def reset(self):
        """NerfSimulator.py:183-223: a fresh workspace, numpy and torch
        seeded, the agent, the estimator and the planner built, A* (raises
        ValueError or AssertionError when there is no path), then
        `learn_init` and the pose cache, or, when the cache existed, the
        cached files copied back and the A* knots kept."""
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
