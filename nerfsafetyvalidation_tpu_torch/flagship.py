"""bench.py's spheres configuration in the port: the trained mip-fold
teacher of `bench_assets/flagship.ckpt` with its occupancy refreshed 4x,
the committed 160x6 student, the four held-out poses at 800x800, and the
frame settings of the modes `fast`, `guided` and `baked_h160_ak8`
(bench.py:177-181, :233-241, :431, :574-606)."""

from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from .assets import load_student, load_teacher, params_from_jax
from .config import NetworkConfig
from .data.rays import get_rays, nerf_matrix_to_ngp
from .data.synthetic import orbit_pose
from .models import make_network
from .models.bake import student_config
from .models.renderer import (render_frame_fast, render_frame_guided,
                              update_extra_state)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "bench_assets" / "flagship.ckpt"
STUDENT = ROOT / "bench_assets" / "bench_student_h160x6.pkl"

RES = 800
FOV_X = 0.6911
HOLDOUT = [(0.77, 0.52), (2.31, 0.30), (3.85, 0.65), (5.40, 0.42)]
REFRESHES = 4
DT_GAMMA = 1.0 / 64

TEACHER_CFG = NetworkConfig(
    encoding="mipfold", bound=1.0, compute_dtype="bfloat16", num_levels=8,
    level_dim=4, base_resolution=16, fold_max_scale=128,
    log2_hashmap_size=19, density_thresh=10.0, grid_size=128, fused=True)
STUDENT_CFG = replace(student_config(
    NetworkConfig(bound=1.0, compute_dtype="bfloat16", grid_size=128),
    multires=12, hidden_dim=160, num_layers=6), fused=True)

# frame settings of each mode; the net each mode shades, and its kernel
MODES = {
    "fast": dict(net="teacher", kernel="K3", frame=dict(
        tile=131072, max_samples=16, max_steps=512, dt_gamma=DT_GAMMA,
        bg_color=1.0)),
    "guided": dict(net="teacher", kernel="K3", frame=dict(
        prepass_factor=8, max_samples=16, tile=16384, max_steps=512,
        dt_gamma=DT_GAMMA, prepass_mode="march", bg_color=1.0,
        margin_cells=6.0)),
    "baked_h160_ak8": dict(net="student", kernel="K1", frame=dict(
        prepass_factor=8, prepass_mode="scout", scout_samples=64,
        max_samples=16, tile=8192,
        adaptive_k=8, adaptive_span_cells=24.0, bg_color=1.0,
        margin_cells=6.0)),
}


def intrinsics(res: int = RES):
    fx = 0.5 * res / np.tan(0.5 * FOV_X)
    return (fx, fx, res / 2, res / 2)


def pose_rays(pose, device, res: int = RES):
    """Full-frame rays (rays_o, rays_d) [res^2, 3] of a raw-frame pose."""
    r = get_rays(nerf_matrix_to_ngp(pose, scale=1.0,
                                    offset=(0.0, 0.0, 0.0))[None],
                 intrinsics(res), res, res, device=device)
    return r["rays_o"][0].contiguous(), r["rays_d"][0].contiguous()


def holdout_poses():
    return [orbit_pose(th, ph, 2.4) for th, ph in HOLDOUT]


def load_teacher_net(device):
    """(folded teacher, the checkpoint's stored RendererState)."""
    params, stored = load_teacher(CKPT, device=device)
    return make_network(TEACHER_CFG, params, device=device).to_folded(), \
        stored


def refresh(teacher, state, seed: int = 100, n: int = REFRESHES):
    """n occupancy refreshes through the teacher, jittered from one seeded
    generator (bench.py refreshes with PRNGKey(100 + i); the draws
    differ)."""
    gen = torch.Generator(device=state.density_grid.device).manual_seed(seed)
    for _ in range(n):
        state = update_extra_state(teacher, state, generator=gen,
                                   grid_size=TEACHER_CFG.grid_size)
    return state


def load_student_net(device):
    return make_network(STUDENT_CFG, params_from_jax(load_student(STUDENT),
                                                     device), device=device)


def render(mode, nets, state, rays_o, rays_d, res: int = RES,
           plain_field: bool = False):
    """One frame of `mode` (a key of MODES); nets maps 'teacher' and
    'student' to their networks."""
    m = MODES[mode]
    net = nets[m["net"]]
    if mode == "fast":
        return render_frame_fast(net, state, rays_o, rays_d,
                                 plain_field=plain_field, **m["frame"])
    return render_frame_guided(net, state, rays_o, rays_d, res, res,
                               plain_field=plain_field, **m["frame"])
