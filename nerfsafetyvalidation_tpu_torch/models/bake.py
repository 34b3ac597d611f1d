"""Distillation of the baked student (nerfsafetyvalidation_tpu/models/
bake.py): `student_config`, the frequency-encoded MLP the baked modes
shade; `distill`, point regression of the student on a teacher's
(sigma, rgb); `finetune_render`, pixel regression of the student's
composite over randomised depth windows against the teacher's marched
render.

The teacher is any module whose forward gives (sigma, rgb) and that has
a `cfg`; it is only read, under `torch.no_grad()`. On the card it is the
served teacher (`flagship.serving_net`), so its queries and `run_grid`'s
launch kernel K3. The student is `student_config`'s, unfused: it trains
through its plain matmul chain under autograd (the JAX package trains it
the same way, outside Pallas), with optax's Adam and cosine decay
(utils/adam.py).

Draws: each step takes its random numbers from `generator` (a
torch.Generator on the state's device; seeded 0 where none is given), or,
where `draws` is given, from draws[i], a dict of tensors for step i. The
tests hand in the JAX package's own draws that way.
"""

from dataclasses import replace

import numpy as np
import torch

from ..config import NetworkConfig
from ..ops.ray_ops import morton3d_invert, near_far_from_aabb
from ..utils.adam import Adam, cosine_decay_schedule
from . import make_network
from .renderer import aabb_of, run_grid

# opacity weight for the color loss: one reference-scale march step
DT_REF = 2.0 * np.sqrt(3.0) / 512.0
# finetune_render: the share of rays shaded over their whole [near, far]
# segment, and the weight of the point-regression anchor
FULLSPAN_FRAC = 0.2
ANCHOR_WEIGHT = 0.25


def student_config(teacher_cfg: NetworkConfig, multires: int = 10,
                   hidden_dim: int = 128, num_layers: int = 4,
                   hidden_dim_color: int = 64) -> NetworkConfig:
    """Frequency-encoded MLP student of a teacher configuration."""
    return replace(teacher_cfg, encoding="frequency", multires=multires,
                   num_layers=num_layers, hidden_dim=hidden_dim,
                   hidden_dim_color=hidden_dim_color, fused=False)


def _occupied_cells(state, grid_size: int):
    """Morton-ordered occupied-cell centres [M, 3] in [-1, 1] (cascade 0)
    of the density bitfield, float32 on its device; one cell (code 0)
    where none is occupied."""
    bits = state.density_bitfield[: grid_size ** 3 // 8]
    shifts = torch.arange(8, device=bits.device, dtype=torch.uint8)
    occ = ((bits[:, None] >> shifts) & 1).reshape(-1)    # little bit order
    idx = torch.nonzero(occ)[:, 0].to(torch.int32)
    if idx.numel() == 0:
        idx = torch.zeros((1,), dtype=torch.int32, device=bits.device)
    coords = morton3d_invert(idx)
    return 2.0 * (coords.to(torch.float32) + 0.5) / grid_size - 1.0


def huber_loss(predictions, targets, delta: float = 1.0):
    """optax.huber_loss, elementwise."""
    abs_errors = torch.abs(predictions - targets)
    quadratic = torch.clamp(abs_errors, max=delta)
    linear = abs_errors - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def _device_of(state):
    return state.density_bitfield.device


def _generator(generator, device):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def _trainer(student_cfg, params, device, lr, steps, generator=None):
    """(a trainable student net holding `params`, or an init drawn from
    `generator` where params is None; its Adam with cosine decay over
    `steps`)."""
    net = make_network(student_cfg, params, device=device, trainable=True,
                       generator=generator)
    return net, Adam(net.param_list(), cosine_decay_schedule(lr, steps))


def _adam_step(net, adam, loss):
    params = net.param_list()
    grads = torch.autograd.grad(loss, params)
    new = adam.step(params, grads)
    with torch.no_grad():
        for p, w in zip(params, new):
            p.copy_(w)


def distill(teacher, state, steps: int = 2000, batch: int = 32768,
            lr: float = 2e-3, surface_frac: float = 0.5,
            cfg: NetworkConfig = None, log_every: int = 0,
            sigma_opacity_weight: float = 0.0, generator=None, draws=None,
            init_params=None, on_step=None):
    """Point regression of a fresh student on the teacher. Each step draws
    `batch` points: a `surface_frac` share jittered +-1.5 half-cells
    around occupied cells of `state`'s cascade 0, the rest uniform in the
    bound, with unit directions from normals; regresses log1p(sigma)
    (Huber, delta 1) everywhere and rgb weighted by the teacher's opacity
    over one reference march step. draws[i]: {'ci': [n_surf] cell
    indices, 'jitter': [n_surf, 3] in [-1.5, 1.5), 'x_uni': [batch -
    n_surf, 3] in [-bound, bound), 'normals': [batch, 3]}. The student
    starts from `init_params` (a params pytree), else from an init drawn
    from the generator. `on_step(i, loss)` runs after step i with its loss
    tensor. Returns (student, params, final_loss): the trained net, its
    params pytree, the last step's loss."""
    dev = _device_of(state)
    tcfg = teacher.cfg
    cfg = cfg or student_config(tcfg)
    if draws is None:
        generator = _generator(generator, dev)
    student, adam = _trainer(cfg, init_params, dev, lr, steps, generator)

    cells = _occupied_cells(state, tcfg.grid_size)
    n_cells = cells.shape[0]
    bound = tcfg.bound
    cell_half = bound / tcfg.grid_size
    n_surf = int(batch * surface_frac)

    def draw(i):
        if draws is not None:
            return draws[i]
        g = generator
        return {"ci": torch.randint(0, n_cells, (n_surf,), generator=g,
                                    device=dev),
                "jitter": torch.rand((n_surf, 3), generator=g, device=dev)
                * 3.0 - 1.5,
                "x_uni": torch.rand((batch - n_surf, 3), generator=g,
                                    device=dev) * (2.0 * bound) - bound,
                "normals": torch.randn((batch, 3), generator=g,
                                       device=dev)}

    loss = None
    for i in range(steps):
        r = draw(i)
        x_surf = cells[r["ci"].long()] * bound + r["jitter"] * cell_half
        x = torch.clamp(torch.cat([x_surf, r["x_uni"]], dim=0), -bound,
                        bound)
        d = r["normals"] / torch.linalg.norm(r["normals"], dim=-1,
                                             keepdim=True)
        with torch.no_grad():
            sig_t, rgb_t = teacher(x, d)
            w_rgb = 1.0 - torch.exp(-DT_REF * sig_t)
            w_sig = 1.0 + sigma_opacity_weight * w_rgb
        sig_s, rgb_s = student(x, d)
        l_sig = torch.sum(w_sig * huber_loss(torch.log1p(sig_s),
                                             torch.log1p(sig_t))) \
            / torch.sum(w_sig)
        l_rgb = torch.sum(w_rgb[:, None] * (rgb_s - rgb_t) ** 2) \
            / (3.0 * torch.sum(w_rgb) + 1e-6)
        loss = l_sig + l_rgb
        _adam_step(student, adam, loss)
        loss = loss.detach()
        if on_step is not None:
            on_step(i, loss)
        if log_every and (i + 1) % log_every == 0:
            print(f"[distill] step {i + 1}/{steps} loss {float(loss):.5f}")
    return student, student.params_tree(), float(loss)


def finetune_render(student, sparams, teacher, state, rays_o_pool,
                    rays_d_pool, steps: int = 2000, batch: int = 8192,
                    K: int = 16, margin_cells: float = 6.0, lr: float = 5e-4,
                    teacher_K: int = 16, dt_gamma: float = 1.0 / 64,
                    max_steps: int = 512, log_every: int = 0,
                    generator=None, draws=None, on_step=None):
    """Pixel regression of the student (`student`'s configuration, from
    the params pytree `sparams`) on the teacher's marched render
    (`run_grid`, teacher_K samples a ray, two a hit, white background) of
    `batch` rays drawn from the pool [P, 3]. Each ray is shaded at K
    uniform samples of a random window around the teacher's depth: margin
    margin_cells cells times a scale in [0.7, 2.2), the centre jittered by
    +-margin/2, a FULLSPAN_FRAC share of rays (and every ray the teacher
    sees through) over the whole [near, far]; the loss is the composite's
    MSE plus ANCHOR_WEIGHT times the point regression against the teacher
    at the same samples. draws[i]: {'idx': [batch] pool indices,
    'mscale': [batch] in [0.7, 2.2), 'cjit': [batch] in [-0.5, 0.5)
    (times the margin), 'full_u': [batch] in [0, 1)}. `on_step(i, loss)`
    runs after step i. Returns (sparams, final_loss)."""
    dev = _device_of(state)
    cfg = teacher.cfg
    bound = cfg.bound
    margin = margin_cells * (2.0 * bound / cfg.grid_size)
    n_pool = rays_o_pool.shape[0]
    aabb = aabb_of(cfg, dev)
    if draws is None:
        generator = _generator(generator, dev)
    net, adam = _trainer(student.cfg, sparams, dev, lr, steps)
    jj = torch.arange(K, dtype=torch.float32, device=dev) + 0.5

    def draw(i):
        if draws is not None:
            return draws[i]
        g = generator
        return {"idx": torch.randint(0, n_pool, (batch,), generator=g,
                                     device=dev),
                "mscale": torch.rand((batch,), generator=g, device=dev)
                * 1.5 + 0.7,
                "cjit": torch.rand((batch,), generator=g, device=dev) - 0.5,
                "full_u": torch.rand((batch,), generator=g, device=dev)}

    loss = None
    for i in range(steps):
        r = draw(i)
        with torch.no_grad():
            idx = r["idx"].long()
            ro, rd = rays_o_pool[idx], rays_d_pool[idx]
            t_out = run_grid(teacher, state, ro, rd, max_samples=teacher_K,
                             max_steps=max_steps, dt_gamma=dt_gamma,
                             bg_color=1.0, samples_per_hit=2)
            target, ws_t = t_out["image"], t_out["weights_sum"]
            nears, fars = near_far_from_aabb(ro, rd, aabb, cfg.min_near)
            hit = ws_t > 0.1
            t_hit = t_out["depth_abs"] / torch.clamp(ws_t, min=0.1)
            m_r = margin * r["mscale"]
            ctr = t_hit + r["cjit"] * margin
            win = hit & ~(r["full_u"] < FULLSPAN_FRAC)
            t0 = torch.where(win, torch.clamp(ctr - m_r, nears, fars), nears)
            t1 = torch.where(win, torch.clamp(ctr + m_r, nears, fars), fars)
            dtw = (t1 - t0) / K
            z = t0[:, None] + dtw[:, None] * jj[None, :]          # [B, K]
            xyz = torch.clamp(ro[:, None, :] + z[..., None] * rd[:, None, :],
                              -bound, bound).reshape(-1, 3)
            dirs = rd[:, None, :].expand(batch, K, 3).reshape(-1, 3)
            # teacher point targets at the same samples (the anchor)
            sig_a, rgb_a = teacher(xyz, dirs)
            w_a = 1.0 - torch.exp(-DT_REF * sig_a)
        sig, rgb = net(xyz, dirs)
        l_anchor = torch.mean(huber_loss(torch.log1p(sig),
                                         torch.log1p(sig_a))) \
            + torch.sum(w_a[:, None] * (rgb - rgb_a) ** 2) \
            / (3.0 * torch.sum(w_a) + 1e-6)
        sig = sig.reshape(batch, K)
        rgb = rgb.reshape(batch, K, 3)
        alphas = 1.0 - torch.exp(-dtw[:, None] * cfg.density_scale * sig)
        shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                             1.0 - alphas + 1e-15], dim=-1)
        trans = torch.cumprod(shifted, dim=-1)[:, :-1]
        wgt = alphas * trans
        ws = torch.sum(wgt, dim=-1)
        img = torch.sum(wgt[..., None] * rgb, dim=-2) \
            + (1.0 - ws)[..., None]                               # white bg
        loss = torch.mean((img - target) ** 2) + ANCHOR_WEIGHT * l_anchor
        _adam_step(net, adam, loss)
        loss = loss.detach()
        if on_step is not None:
            on_step(i, loss)
        if log_every and (i + 1) % log_every == 0:
            print(f"[finetune] step {i + 1}/{steps} loss {float(loss):.6f}")
    return net.params_tree(), float(loss)
