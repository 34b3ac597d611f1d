"""Quadrotor dynamics (nerfsafetyvalidation_tpu/nav/agent.py):
`drone_dynamics` and `add_noise_to_state`, batched over the leading
dimensions of the state. The `Agent` class and its camera are not ported
yet."""

import torch

from .math_utils import rot_matrix_to_vec, vec_to_rot_matrix


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
