"""Rotation / SE(3) math (nerfsafetyvalidation_tpu/nav/math_utils.py):
`rot_x`, `nerf_matrix_to_ngp` (the JAX `nerf_matrix_to_ngp_jax`),
`skew_matrix`, `_acos_safe`, `rot_matrix_to_vec`, `vec_to_rot_matrix` and
`next_rotation` and `mahalanobis` in torch, batched over leading
dimensions, float32 like the JAX versions; and the numpy SE(3) errors
(`calcSO3Err`, `calcSE3Err`) that the sequential estimator prints.

The JAX package's Taylor guards are kept: `rot_matrix_to_vec` switches to
angle / (2 sin angle) ~ 1/2 + angle^2 / 12 below an angle of 1e-4, and
`vec_to_rot_matrix` to the series of sin t / t and (1 - cos t) / t^2 below
t^2 = 1e-12, so both are finite at the identity."""

import numpy as np
import torch


def rot_x(phi, device=None):
    """[3, 3] rotation about x by phi (a float), computed in float32 as the
    JAX `rot_x` computes cos and sin of a float32 phi."""
    p = torch.as_tensor(phi, dtype=torch.float32, device=device)
    c, s = torch.cos(p), torch.sin(p)
    one, zero = torch.ones_like(p), torch.zeros_like(p)
    return torch.stack([torch.stack([one, zero, zero]),
                        torch.stack([zero, c, -s]),
                        torch.stack([zero, s, c])])


_NEG_YZ = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))
_FLIP_YZ = ((0.0, 1.0, 0.0), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0))


def nerf_matrix_to_ngp(pose, trans):
    """(flip_yz @ pose @ neg_yz, flip_yz @ trans) for pose [..., 3, 3] and
    trans [..., 3] (the JAX `nerf_matrix_to_ngp_jax`)."""
    neg = torch.tensor(_NEG_YZ, dtype=pose.dtype, device=pose.device)
    flip = torch.tensor(_FLIP_YZ, dtype=pose.dtype, device=pose.device)
    return flip @ pose @ neg, (flip @ trans[..., None])[..., 0]


def skew_matrix(vec):
    """[..., 3] -> [..., 3, 3]."""
    zeros = torch.zeros_like(vec[..., 0])
    rows = [torch.stack([zeros, -vec[..., 2], vec[..., 1]], dim=-1),
            torch.stack([vec[..., 2], zeros, -vec[..., 0]], dim=-1),
            torch.stack([-vec[..., 1], vec[..., 0], zeros], dim=-1)]
    return torch.stack(rows, dim=-2)


def _acos_safe(x, eps: float = 1e-7):
    """acos with linear extrapolation where |x| > 1 - eps."""
    slope = float(np.arccos(1 - eps) / eps)
    good = torch.abs(x) <= 1 - eps
    sign = torch.sign(x)
    safe = torch.arccos(torch.clamp(x, -(1 - eps), 1 - eps))
    bad = torch.arccos(sign * (1 - eps)) \
        - slope * sign * (torch.abs(x) - 1 + eps)
    return torch.where(good, safe, bad)


def rot_matrix_to_vec(R):
    """[..., 3, 3] -> [..., 3] axis-angle: angle / (2 sin angle) times
    (R - R^T)^vee, the factor Taylor-guarded below an angle of 1e-4."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    angle = _acos_safe((trace - 1) / 2)[..., None]
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = torch.abs(angle) < 1e-4
    denom = torch.where(small, 1.0, 2.0 * torch.sin(angle))
    c = torch.where(small, 0.5 + angle ** 2 / 12.0, angle / denom)
    return c * w


def vec_to_rot_matrix(rot_vec):
    """[..., 3] axis-angle -> [..., 3, 3] by Rodrigues, R = I + a S + b S^2
    with S = skew(rot_vec), a = sin t / t, b = (1 - cos t) / t^2, both
    Taylor-guarded below t^2 = 1e-12."""
    t2 = torch.sum(rot_vec ** 2, dim=-1)[..., None, None]
    small = t2 < 1e-12
    t2s = torch.where(small, 1.0, t2)
    theta = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    S = skew_matrix(rot_vec)
    eye = torch.eye(3, dtype=rot_vec.dtype, device=rot_vec.device)
    return eye + a * S + b * (S @ S)


def next_rotation(R, omega, dt):
    """One SO(3) exponential step, R @ exp(skew(omega dt))."""
    return R @ vec_to_rot_matrix(omega * dt)


def mahalanobis(u, v, cov):
    """(u - v)^T cov^-1 (u - v) for u, v [..., n] and cov [..., n, n]."""
    delta = u - v
    return (delta[..., None, :] @ torch.linalg.inv(cov)
            @ delta[..., :, None])[..., 0, 0]


def as_f32(x, device):
    """x (numpy, a list, or a tensor) as a float32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def calcSO3Err(R_gt, R_est):
    """The angle between two rotations [3, 3] in degrees (numpy;
    math_utils.py:83-91)."""
    rotDiff = np.dot(R_gt, np.transpose(R_est))
    trace = np.trace(rotDiff)
    if trace < -1 and (-1 - trace) < 1e-4:
        return np.rad2deg(np.arccos(-1))
    if trace > 3 and (trace - 3) < 1e-4:
        return np.rad2deg(np.arccos(1))
    return np.rad2deg(np.arccos((trace - 1.0) / 2.0))


def calcSE3Err(T_gt, T_est):
    """(translation error, rotation error in degrees) of two [4, 4] poses."""
    ang = calcSO3Err(T_gt[0:3, 0:3], T_est[0:3, 0:3])
    t_err = np.linalg.norm(T_gt[0:3, 3] - T_est[0:3, 3])
    return t_err, ang
