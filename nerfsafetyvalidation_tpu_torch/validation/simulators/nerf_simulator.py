"""The NeRF-surrogate simulator (nerfsafetyvalidation_tpu/validation/
simulators/nerf_simulator.py; reference NerfSimulator.py): `PlannedEnv`'s
start and goal, agent, SDF grid and `reset` (base.py), the net, the UQ
method and the safety-masked reward.

`step` is one sequential MPC step (NerfSimulator.py:66-155): the planner's
next action through the disturbed dynamics, the observation rendered at
the true pose, the online Gaussian UQ on a second render of it, the
estimator's fit and posterior, the replan from the estimate, and the SDF
check at the last 4 of the states interpolated over the run so far."""

import os

import numpy as np

from ...nav.math_utils import as_f32
from ...uq.orchestrator import uncertainty
from .base import PlannedEnv


class NerfSimulator(PlannedEnv):
    """Arguments as the JAX package's (its `get_rays_fn`, `render_fn`,
    `render_batch_fn` and `density_fn` are tensor functions here); `net`
    is the port's field, which holds its weights (the JAX `params` has no
    counterpart); every tensor lives on `device`."""

    def __init__(self, start_state, end_state, agent_cfg, planner_cfg,
                 camera_cfg, filter_cfg, get_rays_fn, render_fn, blender_cfg,
                 density_fn, uq_method, net, seed, camera=None,
                 sdf_path="validation/utils/sdf.npy", sdf=None,
                 uq_kwargs=None, render_batch_fn=None, device="cuda"):
        super().__init__(start_state, end_state, agent_cfg, planner_cfg,
                         camera_cfg, filter_cfg, get_rays_fn, render_fn,
                         blender_cfg, density_fn, seed, camera=camera,
                         sdf_path=sdf_path, sdf=sdf,
                         render_batch_fn=render_batch_fn, device=device)
        self.uq_method = uq_method
        self.uq_kwargs = uq_kwargs or {}
        self.net = net
        self.current_state = None
        # the collision grid's far corner (NerfSimulator.py:55-62)
        self.END_X, self.END_Y, self.END_Z = 1.0, 1.0, 0.5
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
        interp = self._record_state(true_state, num_interpolated_points)

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

        self._replan(self.filter.estimate_state(nerf_image_u8, true_pose,
                                                action))
        collided, collisionVal, current_state = self._sdf_check(
            interp[-num_interpolated_points:])
        if not collided:
            self.iter += 1
        return collided, collisionVal, current_state[:3], sigma, trace

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
