"""Quadrotor dynamics and agent (nerfsafetyvalidation_tpu/nav/agent.py):
`drone_dynamics` and `add_noise_to_state`, batched over the leading
dimensions of the state, and `Agent`, which steps one drone and captures
its camera's observation (nav/camera.py)."""

import json
import math

import numpy as np
import torch

from .camera import BlenderCamera, CameraBackend
from .math_utils import as_f32, rot_matrix_to_vec, rot_x, vec_to_rot_matrix


def add_noise_to_state(state, noise):
    return state + noise


def _matvec(M, x):
    return (M @ x[..., None])[..., 0]


def drone_dynamics(state, action, dt, g, mass, I, invI):
    """One Euler step of the 12-D quadrotor, state [..., 12] = [pos, vel,
    rotvec, omega], action [..., 4] = [fz, tau_x, tau_y, tau_z] (or one
    [4] for every state); dt, g, mass floats; I, invI [3, 3]. The rotation
    advances by the SO(3) exponential of omega dt."""
    fz = action[..., 0]
    tau = action[..., 1:]
    pos = state[..., 0:3]
    v = state[..., 3:6]
    R = vec_to_rot_matrix(state[..., 6:9])
    omega = state[..., 9:]

    sum_action = torch.stack([torch.zeros_like(fz), torch.zeros_like(fz),
                              fz], dim=-1)
    gravity = torch.tensor([0.0, 0.0, -mass * g], dtype=state.dtype,
                           device=state.device)
    dv = (gravity + _matvec(R, sum_action)) / mass
    domega = _matvec(invI, tau - torch.linalg.cross(
        omega, _matvec(I, omega).expand_as(omega), dim=-1))
    next_R = R @ vec_to_rot_matrix(omega * dt)
    return torch.cat([pos + v * dt, v + dv * dt, rot_matrix_to_vec(next_R),
                      omega + domega * dt], dim=-1)


class Agent:
    """One drone (agent_helpers.py:13-191): its state [12] on `device`,
    the dynamics, and the camera, rotated +90 degrees about the body's x
    axis. camera: a CameraBackend, else a BlenderCamera from blender_cfg
    ({'blend_path', 'script_path'})."""

    def __init__(self, agent_cfg, camera_cfg, blender_cfg=None,
                 camera: CameraBackend = None, device="cuda"):
        self.device = dev = torch.device(device)
        self.path = camera_cfg.get("path", "./sim_img_cache")
        self.half_res = camera_cfg.get("half_res", False)
        self.white_bg = camera_cfg.get("white_bg", True)
        self.data = {"pose": None, "res_x": camera_cfg["res_x"],
                     "res_y": camera_cfg["res_y"],
                     "trans": camera_cfg["trans"],
                     "mode": camera_cfg["mode"]}
        if camera is not None:
            self.camera = camera
        else:
            self.camera = BlenderCamera(
                self.path, blender_cfg["blend_path"],
                blender_cfg["script_path"], half_res=self.half_res,
                white_bg=self.white_bg)
        self.iter = 0
        self.x = as_f32(agent_cfg["x0"], dev)
        self.dt = float(agent_cfg["dt"])
        self.g = float(agent_cfg["g"])
        self.mass = float(agent_cfg["mass"])
        self.I = as_f32(agent_cfg["I"], dev)
        self.invI = torch.linalg.inv(self.I)
        self.states_history = [self.x.cpu().numpy().tolist()]

    def drone_dynamics(self, state, action):
        return drone_dynamics(as_f32(state, self.device),
                              as_f32(action, self.device).reshape(-1),
                              self.dt, self.g, self.mass, self.I, self.invI)

    def _camera_pose(self, state):
        """[4, 4] numpy: rot_x(pi/2) @ R at the state's position."""
        pose = np.eye(4, dtype=np.float32)
        R = vec_to_rot_matrix(torch.as_tensor(np.asarray(state[6:9]),
                                              dtype=torch.float32))
        pose[:3, :3] = (rot_x(math.pi / 2) @ R).numpy()
        pose[:3, 3] = np.asarray(state[:3])
        return pose

    def _capture(self, new_state):
        new_pose = self._camera_pose(new_state)
        self.data["pose"] = new_pose.tolist()
        img = self.camera.capture(self.data, self.iter)
        self.states_history.append(new_state.tolist())
        return new_pose, img

    @torch.no_grad()
    def step(self, action, noise=None):
        """The dynamics, plus the disturbance `noise` [12], and the
        observation (agent_helpers.py:43-77). Returns (the body-frame pose
        [4, 4], the state [12], the image [H, W, 3] uint8), numpy."""
        newstate = self.drone_dynamics(self.x, action)
        if noise is not None:
            newstate = add_noise_to_state(newstate, as_f32(noise, self.device))
        self.x = newstate
        new_state = newstate.cpu().numpy()
        new_pose, img = self._capture(new_state)
        self.iter += 1
        # the camera's pose back to the body frame (agent_helpers.py:75)
        new_pose[:3, :3] = rot_x(-math.pi / 2).numpy() @ new_pose[:3, :3]
        return new_pose, new_state, img

    def state2image(self, state):
        """Set the state and capture (agent_helpers.py:79-100)."""
        self.x = as_f32(state, self.device)
        new_state = self.x.cpu().numpy()
        new_pose, self.img = self._capture(new_state)
        return new_pose, new_state, self.img

    def save_data(self, filename):
        with open(filename, "w+") as f:
            json.dump({"true_states": self.states_history}, f)
