"""The vision-based state estimator (nerfsafetyvalidation_tpu/nav/
estimator.py; reference nav/estimator_helpers.py `Estimator`), an EKF-style
filter with a photometric update:

  * `find_POI`: SIFT keypoints on the observation (host cv2), else a
    gradient-magnitude detector (the pixels above the 95th percentile);
  * `estimate_relative_pose`: the interest pixels dilated, `batch_size` of
    them drawn with numpy's generator seeded by the step, then `N_iter`
    Adam steps on `measurement_fn` from the propagated state;
  * `measurement_fn`: the masked rays' rendered colour against the
    observation (mean squared error) plus the Mahalanobis prior around the
    propagated state, the camera at rot_x(pi/2) R in the NGP axes;
  * `estimate_state`: the dynamics' 12x12 Jacobian propagates the
    covariance; after the fit, the inverse Hessian of the measurement at
    the optimum is the posterior covariance.

The JAX package jits the Adam loop as one `fori_loop` and takes
`jax.jacfwd` and `jax.hessian`. Here each Adam step is a forward and a
backward on the render's device (utils/adam.py, optax's order of
operations), and the Jacobian and the Hessian come from 12 backward and 12
double-backward passes (utils/autodiff.py, shared with the closed-loop
engine). What the JAX package runs on the host runs on the host here too:
`find_POI`, the dilation, the batch draw and the SE(3) error print."""

import json
import math
import pathlib

import numpy as np
import torch

from ..utils.adam import Adam
from ..utils.autodiff import hessian_rows, jacobian_rows
from .math_utils import (as_f32, calcSE3Err, mahalanobis, nerf_matrix_to_ngp,
                         rot_x, vec_to_rot_matrix)


def find_POI(img_rgb, render=False):
    """Interest points of an RGB image [H, W, 3] (uint8): unique integer
    pixel coordinates [N, 2] as cv2's keypoints give them (x, y), and
    {'features': the keypoint drawing or None} (estimator_helpers.py:
    10-36). Without cv2 (or when SIFT fails) the pixels whose gradient
    magnitude exceeds its 95th percentile, the same (x, y) order."""
    img = np.copy(np.asarray(img_rgb))
    feat_img = None
    try:
        import cv2
        img_gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        sift = cv2.SIFT_create()
        keypoints = sift.detect(img, None)
        if render:
            feat_img = cv2.drawKeypoints(img_gray, keypoints, img)
        xy = np.array([kp.pt for kp in keypoints]).astype(int)
    except Exception:
        gray = img.mean(-1) if img.ndim == 3 else img
        gy, gx = np.gradient(gray.astype(np.float32))
        mag = np.hypot(gx, gy)
        thresh = np.percentile(mag, 95)
        ys, xs = np.nonzero(mag > thresh)
        xy = np.stack([xs, ys], axis=-1)
    if xy.size == 0:
        return np.zeros((0,), dtype=int), {"features": feat_img}
    xy_set = set(tuple(p) for p in xy)
    xy = np.array([list(p) for p in xy_set]).astype(int)
    return xy, {"features": feat_img}


def detector() -> str:
    """Which detector `find_POI` runs here: 'sift' when cv2 has it, else
    'gradient'."""
    try:
        import cv2
        cv2.SIFT_create()
        return "sift"
    except Exception:
        return "gradient"


def dilate(interest, kernel_size, iterations):
    """The binary interest mask [H, W] dilated by a kernel_size square,
    `iterations` times: cv2.dilate, else scipy's binary_dilation."""
    try:
        import cv2
        return cv2.dilate(interest, np.ones((kernel_size, kernel_size),
                                            np.uint8),
                          iterations=iterations)
    except Exception:
        from scipy import ndimage
        return ndimage.binary_dilation(
            interest, np.ones((kernel_size, kernel_size)),
            iterations=iterations).astype(np.uint8)


class Estimator:
    """filter_cfg: batch_size, kernel_size, dil_iter, lrate, N_iter, sig0
    [12, 12], Q [12, 12] (render_viz, show_rate, fixed_coords optional);
    agent: its `drone_dynamics(state, action)`; start_state [12];
    get_rays_fn(pose [1, 4, 4]) -> {'rays_o', 'rays_d'} [1, H*W, 3],
    differentiable in the pose; render_fn (the staged frame) and
    render_batch_fn (one call, differentiable twice in the rays)
    (rays_o, rays_d [1, N, 3]) -> {'image', ...}. Every tensor lives on
    `device` (default: the agent's)."""

    def __init__(self, filter_cfg, agent, start_state, filter=True,
                 get_rays_fn=None, render_fn=None, render_batch_fn=None,
                 device=None):
        if device is None:
            device = getattr(agent, "device", "cpu")
        self.device = dev = torch.device(device)
        self.batch_size = filter_cfg["batch_size"]
        self.kernel_size = filter_cfg["kernel_size"]
        self.dil_iter = filter_cfg["dil_iter"]
        self.lrate = filter_cfg["lrate"]
        self.agent = agent
        self.is_filter = filter
        self.render_viz = filter_cfg.get("render_viz", False)
        self.show_rate = filter_cfg.get("show_rate", [20, 100])
        self.error_print_rate, self.render_rate = self.show_rate
        # fixed interest pixels [B, 2] (row, col): skip find_POI, the
        # dilation and the draw (the closed-loop engine's interest grid)
        fc = filter_cfg.get("fixed_coords")
        self.fixed_coords = None if fc is None else np.asarray(fc, dtype=int)

        self.xt = as_f32(start_state, dev)
        self.sig = as_f32(filter_cfg["sig0"], dev)
        self.Q = as_f32(filter_cfg["Q"], dev)
        self.iter = filter_cfg["N_iter"]

        self.get_rays = get_rays_fn
        self.render_fn = render_fn
        self.render_batch_fn = render_batch_fn or render_fn

        self.losses = None
        self.covariance = None
        self.state_estimate = None
        self.states = None
        self.action = None
        self.target = None
        self.batch = None
        self.iteration = 0
        self.basefolder = None

    # ------------------------------------------------------------- rendering
    def _pose_from_state(self, state):
        """12-state -> the NGP camera pose [4, 4] (estimator_helpers.py:
        199-208), differentiable in the state."""
        R = vec_to_rot_matrix(state[6:9])
        rot = rot_x(math.pi / 2, self.device) @ R
        pose, trans = nerf_matrix_to_ngp(rot, state[:3])
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=self.device)
        return torch.cat([torch.cat([pose, trans[:, None]], dim=1), bottom])

    def measurement_fn(self, state, start_state, sig, target, batch):
        """The photometric loss plus the dynamics prior (estimator_helpers
        .py:191-225). target [H, W, 3] float; batch [B, 2] (row, col)."""
        loss_dyn = mahalanobis(state, start_state, sig)
        H, W = target.shape[0], target.shape[1]
        new_pose = self._pose_from_state(state)
        rays = self.get_rays(new_pose.reshape(1, 4, 4))
        rays_o = rays["rays_o"].reshape(H, W, -1)[batch[:, 0], batch[:, 1]]
        rays_d = rays["rays_d"].reshape(H, W, -1)[batch[:, 0], batch[:, 1]]
        output = self.render_batch_fn(rays_o.reshape(1, -1, 3),
                                      rays_d.reshape(1, -1, 3))
        rgb = output["image"].reshape(-1, 3)
        tgt = target[batch[:, 0], batch[:, 1]]
        loss_rgb = torch.mean((rgb - tgt) ** 2)
        return loss_rgb + loss_dyn

    def _camera_rays(self, pose):
        """The body pose [4, 4] -> the observation camera's rays."""
        pose = as_f32(pose, self.device)
        rot = rot_x(math.pi / 2, self.device) @ pose[:3, :3]
        p, t = nerf_matrix_to_ngp(rot, pose[:3, 3])
        new_pose = torch.eye(4, device=self.device)
        new_pose[:3, :3] = p
        new_pose[:3, 3] = t
        return self.get_rays(new_pose.reshape(1, 4, 4))

    @torch.no_grad()
    def render_from_pose(self, pose):
        """The frame at a body pose [4, 4] (estimator_helpers.py:227-243):
        the image, squeezed."""
        rays = self._camera_rays(pose)
        output = self.render_fn(rays["rays_o"], rays["rays_d"])
        return torch.squeeze(output["image"])

    @torch.no_grad()
    def render_for_uncertainty(self, pose):
        """estimator_helpers.py:245-259: (the render's dict, rays_o,
        rays_d)."""
        rays = self._camera_rays(pose)
        output = self.render_fn(rays["rays_o"], rays["rays_d"])
        return output, rays["rays_o"], rays["rays_d"]

    # ----------------------------------------------------------- pose update
    def fit(self, state0, start_state, sig, target, batch):
        """N_iter Adam steps on measurement_fn from state0. Returns (the
        state, the losses [N_iter]), on the device."""
        adam = Adam([state0], self.lrate)
        state, losses = state0, []
        for _ in range(self.iter):
            with torch.enable_grad():
                leaf = state.detach().requires_grad_(True)
                loss = self.measurement_fn(leaf, start_state, sig, target,
                                           batch)
                grad, = torch.autograd.grad(loss, leaf)
            losses.append(loss.detach())
            state, = adam.step([state], [grad])
        return state, torch.stack(losses) if losses else torch.zeros(0)

    def _interest_batch(self, obs_img, POI):
        """The dilated interest region's pixels, batch_size of them drawn
        (with replacement when the region is smaller) by numpy's
        generator seeded with the step (estimator_helpers.py:100-120)."""
        W_obs, H_obs = obs_img.shape[0], obs_img.shape[1]
        interest = np.zeros((H_obs, W_obs), dtype=np.uint8)
        POI = POI[(POI[:, 0] < H_obs) & (POI[:, 1] < W_obs)]
        interest[POI[:, 0], POI[:, 1]] = 1
        interest = dilate(interest, self.kernel_size, self.dil_iter)
        coords = np.argwhere(interest.astype(bool))  # [M, 2] (row, col)
        rng = np.random.default_rng(self.iteration)
        take = self.batch_size
        idx = rng.choice(coords.shape[0], size=take,
                         replace=coords.shape[0] < take)
        return coords[idx]

    def estimate_relative_pose(self, sensor_image, start_state, sig,
                               obs_img_pose=None):
        """estimator_helpers.py:77-189. sensor_image: uint8 [H, W, 3].
        Returns (the state, whether features were found)."""
        obs_img = np.asarray(sensor_image)
        if self.fixed_coords is not None:
            coords = self.fixed_coords
        else:
            POI, extras = find_POI(obs_img, render=self.render_viz)
            print(f"Found {POI.shape[0]} features")
            if len(POI.shape) == 1 or POI.shape[0] == 0:
                self.losses = []
                self.states = []
                print("Feature Detection Failed.".center(20, "."))
                return as_f32(start_state, self.device), False
            coords = self._interest_batch(obs_img, POI)
        target = torch.from_numpy(obs_img.astype(np.float32) / 255.0).to(
            self.device)
        batch = torch.as_tensor(coords, dtype=torch.int64,
                                device=self.device)
        start_state = as_f32(start_state, self.device)
        optimized, losses = self.fit(start_state + 1e-6, start_state, sig,
                                     target, batch)

        if obs_img_pose is not None and self.fixed_coords is None:
            pose = np.eye(4)
            pose[:3, :3] = vec_to_rot_matrix(optimized[6:9]).cpu().numpy()
            pose[:3, 3] = optimized[:3].cpu().numpy()
            print("final error", calcSE3Err(pose, np.asarray(obs_img_pose)))

        self.target = target
        self.batch = batch
        self.losses = losses.cpu().numpy().tolist()
        self.states = [optimized.cpu().numpy().tolist()]
        if self.fixed_coords is None:
            print("Done with main relative_pose_estimation loop")
        return optimized, True

    def estimate_state(self, sensor_img, obs_img_pose, action):
        """estimator_helpers.py:261-319: propagate the state and its
        covariance, fit, and (as a filter, when features were found) the
        posterior covariance; the step's JSON under basefolder."""
        action = as_f32(action, self.device).reshape(-1)
        self.xt = self.agent.drone_dynamics(self.xt, action).detach()
        self.action = action.cpu().numpy().tolist()

        A = jacobian_rows(lambda x: self.agent.drone_dynamics(x, action),
                          self.xt)
        sig_prop = A @ self.sig @ A.T + self.Q

        xt, success = self.estimate_relative_pose(
            sensor_img, self.xt, sig_prop, obs_img_pose=obs_img_pose)

        if self.is_filter and success:
            hess = hessian_rows(
                lambda x: self.measurement_fn(x, self.xt, sig_prop,
                                              self.target, self.batch), xt)
            self.sig = torch.linalg.inv(hess)

        self.xt = xt.detach()
        self.covariance = self.sig.cpu().numpy().tolist()
        self.state_estimate = self.xt.cpu().numpy().tolist()

        if self.basefolder is not None:
            save_path = pathlib.Path(self.basefolder) / "estimator_data" / \
                f"step{self.iteration}.json"
            save_path.parent.mkdir(parents=True, exist_ok=True)
            self.save_data(save_path)
        self.iteration += 1
        return self.xt

    def save_data(self, filename):
        with open(filename, "w+") as f:
            json.dump({
                "loss": self.losses,
                "covariance": self.covariance,
                "state_estimate": self.state_estimate,
                "grad_states": self.states,
                "action": self.action,
            }, f, indent=4)
