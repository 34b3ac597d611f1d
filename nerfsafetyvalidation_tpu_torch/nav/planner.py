"""Trajectory planner over the NeRF's density (nerfsafetyvalidation_tpu/
nav/planner.py; reference nav/quad_plot.py):

* `a_star_init`: A* (nav/astar.py) on the 100^3 density probe max-pooled
  to 20^3 cells (occupied above 0.3), its cells jittered by numpy's global
  normal draws and smoothed over 3 knots;
* `calc_everything`: the differentiable flat-state reconstruction of the
  full trajectory and its actions from the knots;
* `planner_cost_terms`: 1000 fz^2 + 0.01 |tau|^4 + 1e6 mean_B(density^2
  speed) over the robot's body points, with the optional fade-out mask;
* `learn_init` / `learn_update`: Adam on the mean cost, with the pose and
  cost JSON files every SAVE_STEP epochs; `update_state` shifts the
  horizon after a measurement (dropping a knot, or with `fixed_horizon`
  consuming the first and repeating the last).

`calc_everything` and `planner_cost_terms` take leading population
dimensions (knots [..., S, 4]), so the closed-loop engine replans every
sim in one call. The JAX package jits an epoch block as one `fori_loop`;
here every epoch is a forward and backward on the planner's device, the
density through the net's kernels (K4 with `--ff`)."""

import json
import pathlib

import numpy as np
import torch

from ..utils.adam import Adam
from .astar import astar
from .math_utils import as_f32, next_rotation, rot_matrix_to_vec

SAVE_STEP = 50


def _e3(like):
    return torch.tensor([0.0, 0.0, 1.0], dtype=like.dtype,
                        device=like.device)


def calc_everything(states, initial_accel, start_state, end_state, dt, g_vec,
                    J, mass):
    """states [..., S, 4] (xyz + yaw knots), initial_accel [..., 2],
    start_state and end_state [18] or [..., 18] ([pos, vel, R (9), omega]);
    g_vec [3], J [3, 3] tensors. Returns (pos, vel, accel [..., S+3, 3],
    rot_matrix [..., S+3, 3, 3], omega, angular_accel [..., S+3, 3],
    actions [..., S+3, 4])."""
    lead = states.shape[:-2]
    start_state = start_state.expand(lead + (18,))
    end_state = end_state.expand(lead + (18,))
    start_pos = start_state[..., None, 0:3]
    start_v = start_state[..., None, 3:6]
    start_R = start_state[..., 6:15].reshape(lead + (1, 3, 3))
    start_omega = start_state[..., None, 15:]
    end_pos = end_state[..., None, 0:3]
    end_v = end_state[..., None, 3:6]
    end_R = end_state[..., 6:15].reshape(lead + (1, 3, 3))
    end_omega = end_state[..., None, 15:]

    next_R = next_rotation(start_R, start_omega, dt)
    e3 = _e3(states)
    start_accel = (start_R @ e3) * initial_accel[..., 0, None, None] + g_vec
    next_accel = (next_R @ e3) * initial_accel[..., 1, None, None] + g_vec

    next_vel = start_v + start_accel * dt
    after_next_vel = next_vel + next_accel * dt
    next_pos = start_pos + start_v * dt
    after_next_pos = next_pos + next_vel * dt
    after2_next_pos = after_next_pos + after_next_vel * dt

    current_pos = torch.cat([start_pos, next_pos, after_next_pos,
                             after2_next_pos, states[..., 2:, :3], end_pos],
                            dim=-2)
    current_vel = (current_pos[..., 1:, :] - current_pos[..., :-1, :]) / dt
    current_vel = torch.cat([current_vel, end_v], dim=-2)
    current_accel = (current_vel[..., 1:, :] - current_vel[..., :-1, :]) \
        / dt - g_vec
    current_accel = torch.cat([current_accel, current_accel[..., -1:, :]],
                              dim=-2)

    accel_mag = torch.linalg.norm(current_accel, dim=-1, keepdim=True)
    z_axis_body = (current_accel / accel_mag)[..., 2:-1, :]
    z_angle = states[..., 3]
    in_plane = torch.stack([torch.sin(z_angle), -torch.cos(z_angle),
                            torch.zeros_like(z_angle)], dim=-1)
    x_axis_body = torch.linalg.cross(z_axis_body, in_plane, dim=-1)
    x_axis_body = x_axis_body / torch.linalg.norm(x_axis_body, dim=-1,
                                                  keepdim=True)
    y_axis_body = torch.linalg.cross(z_axis_body, x_axis_body, dim=-1)
    rot_matrix = torch.stack([x_axis_body, y_axis_body, z_axis_body], dim=-1)
    rot_matrix = torch.cat([start_R, next_R, rot_matrix, end_R], dim=-3)

    current_omega = rot_matrix_to_vec(
        rot_matrix[..., 1:, :, :]
        @ rot_matrix[..., :-1, :, :].transpose(-1, -2)) / dt
    current_omega = torch.cat([current_omega, end_omega], dim=-2)
    angular_accel = (current_omega[..., 1:, :] - current_omega[..., :-1, :]) \
        / dt
    angular_accel = torch.cat([angular_accel, angular_accel[..., -1:, :]],
                              dim=-2)
    torques = (J @ angular_accel[..., None])[..., 0]
    actions = torch.cat([accel_mag * mass, torques], dim=-1)
    return (current_pos, current_vel, current_accel, rot_matrix,
            current_omega, angular_accel, actions)


def planner_cost_terms(states, initial_accel, start_state, end_state, epoch,
                       *, density_fn, dt, g_vec, J, mass, robot_body,
                       fade_out_epoch, fade_out_sharpness):
    """The planner's cost (quad_plot.py:223-253) of knots [..., S, 4]:
    1000 fz^2 + 0.01 |tau|^4 + 1e6 mean over the body points [B, 3] of
    density(world point)^2 times the speed, the last term faded in over
    the horizon while epoch < fade_out_epoch (when > 0). density_fn:
    [..., 3] -> [...]. Returns (total, colision) [..., S+3]."""
    pos, vel, accel, rot_matrix, omega, angular_accel, actions = \
        calc_everything(states, initial_accel, start_state, end_state,
                        dt, g_vec, J, mass)
    fz = actions[..., 0]
    torques = torch.linalg.norm(actions[..., 1:], dim=-1)
    world_body = rot_matrix @ robot_body.T + pos[..., None]   # [.., 3, B]
    world_body = world_body.transpose(-1, -2)                  # [.., B, 3]
    distance = torch.sum(vel ** 2 + 1e-5, dim=-1) ** 0.5
    density = density_fn(world_body) ** 2
    colision_prob = torch.mean(density * distance[..., None], dim=-1)
    if fade_out_epoch > 0:
        t = torch.linspace(0.0, 1.0, colision_prob.shape[-1],
                           device=colision_prob.device)
        position = epoch / fade_out_epoch
        mask = torch.sigmoid(fade_out_sharpness * (position - t))
        if epoch >= fade_out_epoch:
            mask = torch.ones_like(mask)
        colision_prob = colision_prob * mask
    colision_prob = colision_prob * 1e6
    return (1000 * fz ** 2 + 0.01 * torques ** 4 + colision_prob,
            colision_prob)


class Planner:
    def __init__(self, start_state, end_state, cfg, density_fn,
                 device="cuda"):
        """start_state, end_state: [18]; cfg: the validate CLI's
        planner_cfg (T_final, steps, lr, epochs_init, epochs_update,
        fade_out_epoch, fade_out_sharpness, I, g, mass, body, nbins,
        fixed_horizon); density_fn: [..., 3] world points -> [...]
        densities (a tensor function, differentiable in the points)."""
        self.device = dev = torch.device(device)
        self.nerf = density_fn
        self.cfg = cfg
        self.T_final = cfg["T_final"]
        self.steps = cfg["steps"]
        self.lr = cfg["lr"]
        self.epochs_init = cfg["epochs_init"]
        self.epochs_update = cfg["epochs_update"]
        self.fade_out_epoch = cfg["fade_out_epoch"]
        self.fade_out_sharpness = cfg["fade_out_sharpness"]
        self.fixed_horizon = bool(cfg.get("fixed_horizon", False))
        self.mass = float(cfg["mass"])
        self.J = as_f32(cfg["I"], dev)
        self.g = torch.tensor([0.0, 0.0, -float(cfg["g"])], device=dev)
        self.body_extent = np.asarray(cfg["body"])
        self.body_nbins = cfg["nbins"]

        self.dt = self.T_final / self.steps
        self.start_state = as_f32(start_state, dev)
        self.end_state = as_f32(end_state, dev)

        slider = torch.linspace(0.0, 1.0, self.steps, device=dev)[1:-1, None]
        s0 = self.full_to_reduced_state(self.start_state)
        s1 = self.full_to_reduced_state(self.end_state)
        self.states = (1 - slider) * s0 + slider * s1
        self.initial_accel = torch.tensor([cfg["g"], cfg["g"]],
                                          dtype=torch.float32, device=dev)

        bx, by, bz = [np.linspace(self.body_extent[i, 0],
                                  self.body_extent[i, 1], self.body_nbins[i])
                      for i in range(3)]
        gx, gy, gz = np.meshgrid(bx, by, bz, indexing="ij")
        self.robot_body = as_f32(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3),
                               dev)
        self.epoch = 0
        self.basefolder = None

    # ----------------------------------------------------------------- state
    def full_to_reduced_state(self, state):
        """[18] -> [4]: the position and the yaw of the body's x axis."""
        R = state[6:15].reshape(3, 3)
        v = R[:, 0]
        angle = torch.atan2(v[1], v[0])
        return torch.cat([state[:3], angle[None]])

    # --------------------------------------------------------------- A* init
    @torch.no_grad()
    def a_star_init(self, side: int = 100, kernel_size: int = 5):
        """The knots from A* (quad_plot.py:63-114): the density on a side^3
        grid over [-1, 1]^3, max-pooled by kernel_size, occupied above 0.3;
        the path's cells mapped back to [-1, 1], yaw 0, plus N(0, 1e-3)
        from numpy's global generator, smoothed over 3 knots (numpy
        float32, as the JAX package computes them). Raises ValueError (no
        path) or AssertionError (start or goal occupied)."""
        lin = np.linspace(-1, 1, side, dtype=np.float32)
        gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
        coods = torch.from_numpy(np.stack([gx, gy, gz], axis=-1)).to(
            self.device)
        output = self.nerf(coods).float().cpu().numpy()
        gs = side // kernel_size
        self.occupied = output.reshape(gs, kernel_size, gs, kernel_size, gs,
                                       kernel_size).max(axis=(1, 3, 5)) > 0.3

        start_grid = gs * (self.start_state[:3].cpu().numpy() + 1) / 2
        end_grid = gs * (self.end_state[:3].cpu().numpy() + 1) / 2
        start = tuple(int(start_grid[i]) for i in range(3))
        end = tuple(int(end_grid[i]) for i in range(3))

        path = astar(self.occupied, start, end)

        squares = 2 * (np.asarray(path, dtype=np.float32) / gs) - 1
        states = np.concatenate(
            [squares, np.zeros((squares.shape[0], 1), dtype=np.float32)],
            axis=-1)
        states += np.random.normal(0.0, 0.001, states.shape).astype(np.float32)
        prev_s = np.concatenate([states[:1], states[:-1]], axis=0)
        next_s = np.concatenate([states[1:], states[-1:]], axis=0)
        states = (prev_s + next_s + states) / 3
        self.states = torch.from_numpy(states).to(self.device)

    # ------------------------------------------------------------------ cost
    def calc_everything(self, states=None, initial_accel=None):
        states = self.states if states is None else states
        ia = self.initial_accel if initial_accel is None else initial_accel
        return calc_everything(states, ia, self.start_state, self.end_state,
                               self.dt, self.g, self.J, self.mass)

    def _cost_terms(self, states, ia, epoch):
        return planner_cost_terms(
            states, ia, self.start_state, self.end_state, epoch,
            density_fn=self.nerf, dt=self.dt, g_vec=self.g, J=self.J,
            mass=self.mass, robot_body=self.robot_body,
            fade_out_epoch=self.fade_out_epoch,
            fade_out_sharpness=self.fade_out_sharpness)

    def get_state_cost(self):
        return self._cost_terms(self.states, self.initial_accel, self.epoch)

    def total_cost(self):
        return torch.mean(self.get_state_cost()[0])

    # ---------------------------------------------------------- optimization
    def _learn(self, epochs, tag, iteration=None):
        """`epochs` Adam steps on the mean cost from a fresh optimizer; the
        pose and cost files every SAVE_STEP epochs, before the step (as
        the JAX package writes them before each jitted block)."""
        params = [self.states, self.initial_accel]
        adam = Adam(params, self.lr)
        for epoch in range(epochs):
            if epoch % SAVE_STEP == 0 and self.basefolder is not None:
                self.epoch = epoch
                self.states, self.initial_accel = params
                suffix = str(epoch // SAVE_STEP) + \
                    (f"_time{iteration}" if iteration is not None else "")
                base = pathlib.Path(self.basefolder)
                self.save_poses(base / f"{tag}_poses" / (suffix + ".json"))
                self.save_costs(base / f"{tag}_costs" / (suffix + ".json"))
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(True) for p in params]
                total, _ = self._cost_terms(leaves[0], leaves[1], epoch)
                grads = torch.autograd.grad(torch.mean(total), leaves)
            params = adam.step(params, grads)
        self.states, self.initial_accel = params
        self.epoch = epochs

    def learn_init(self):
        """The initial plan: epochs_init epochs (quad_plot.py:255-276)."""
        self._learn(self.epochs_init, "init")

    def learn_update(self, iteration):
        """A replan: epochs_update epochs (quad_plot.py:278-300)."""
        self._learn(self.epochs_update, "replan", iteration=iteration)

    # ------------------------------------------------------------------- MPC
    def get_full_states(self):
        pos, vel, _, rot_matrix, omega, _, _ = self.calc_everything()
        return torch.cat([pos, vel, rot_matrix.reshape(-1, 9), omega], dim=-1)

    def get_actions(self):
        return self.calc_everything()[6]

    def get_next_action(self):
        return self.get_actions()[0, :]

    def body_to_world(self, points):
        pos, _, _, rot_matrix, _, _, _ = self.calc_everything()
        return (rot_matrix @ points.T + pos[..., None]).transpose(-1, -2)

    @torch.no_grad()
    def update_state(self, measured_state):
        """Shift the horizon after a measurement [18] (quad_plot.py:
        302-308): initial_accel from the old plan's actions[1:3, 0]."""
        actions = self.calc_everything()[6]
        self.start_state = as_f32(measured_state, self.device)
        if self.fixed_horizon:
            self.states = torch.cat([self.states[1:], self.states[-1:]])
        else:
            self.states = self.states[1:]
        self.initial_accel = actions[1:3, 0]

    # ------------------------------------------------------------------- IO
    @torch.no_grad()
    def save_poses(self, filename):
        pathlib.Path(filename).parent.mkdir(parents=True, exist_ok=True)
        positions, _, _, rot_matrix, _, _, _ = self.calc_everything()
        poses = []
        for pos, rot in zip(positions.cpu().numpy(),
                            rot_matrix.cpu().numpy()):
            pose = np.zeros((4, 4))
            pose[:3, :3] = rot
            pose[:3, 3] = pos
            pose[3, 3] = 1
            poses.append(pose.tolist())
        with open(filename, "w+") as f:
            json.dump({"poses": poses}, f, indent=4)

    @torch.no_grad()
    def save_costs(self, filename):
        pathlib.Path(filename).parent.mkdir(parents=True, exist_ok=True)
        positions, _, _, _, _, _, actions = self.calc_everything()
        total_cost, colision_loss = self.get_state_cost()
        with open(filename, "w+") as f:
            json.dump({
                "colision_loss": colision_loss.cpu().numpy().tolist(),
                "pos": positions.cpu().numpy().tolist(),
                "actions": actions.cpu().numpy().tolist(),
                "total_cost": total_cost.cpu().numpy().tolist(),
            }, f, indent=4)
