"""Depth-guided frame render of the baked student
(nerfsafetyvalidation_tpu/models/renderer.py `render_frame_guided`, scout
prepass, natural tile order).

A low-resolution scout finds each block's surface depth through the field's
density head, masked by the occupancy bitfield; the full-resolution pass
then shades K uniform samples per ray inside a window around that depth.
The JAX version maps over tiles with `lax.map` and `lax.switch`; here the
tiles are a Python loop. Every tile's bucket (empty / `adaptive_k` samples /
K samples) is computed on the device in one tensor op and copied to the
host once per frame, so the loop never waits on the device per tile.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.marching import _mip_from_dt, _mip_from_pos
from ..ops.ray_ops import morton3d, near_far_from_aabb


@dataclass
class RendererState:
    """Occupancy state; the guided frame reads only the bitfield
    ([cascade * H^3 / 8] uint8, morton order, bit i of byte n = cell
    8n + i)."""
    density_bitfield: torch.Tensor


def aabb_of(cfg, device):
    b = cfg.bound
    return torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32,
                        device=device)


def _scout_field(net, pre_o, pre_d, S, cfg, aabb, bitfield=None,
                 grid_size: int = 128):
    """S uniform samples per prepass ray through the density head, masked by
    the occupancy bitfield, one transmittance composite. Returns
    (pre_dabs, pre_ws): the opacity-weighted sample t and the opacity."""
    P = pre_o.shape[0]
    nrp, frp = near_far_from_aabb(pre_o, pre_d, aabb, cfg.min_near)
    dtp = (frp - nrp) / S
    jjp = torch.arange(S, dtype=torch.float32, device=pre_o.device) + 0.5
    z = nrp[:, None] + dtp[:, None] * jjp[None, :]                 # [P, S]
    xyz = torch.clamp(pre_o[:, None, :] + z[..., None] * pre_d[:, None, :],
                      -cfg.bound, cfg.bound).reshape(-1, 3)
    sig = net.density(xyz)["sigma"].reshape(P, S)
    if bitfield is not None:
        H = grid_size
        pos = xyz.reshape(P, S, 3)
        level = torch.maximum(_mip_from_pos(pos, cfg.cascade),
                              _mip_from_dt(dtp[:, None], H, cfg.cascade))
        mip_bound = torch.clamp(torch.exp2(level.float()), max=cfg.bound)
        nxyz = torch.clamp(0.5 * (pos / mip_bound[..., None] + 1.0) * H,
                           0.0, H - 1).to(torch.int32)
        index = (level.to(torch.int64) * H ** 3
                 + morton3d(nxyz.reshape(-1, 3)).reshape(P, S))
        byte = bitfield[index >> 3].to(torch.int64)
        occ = ((byte >> (index & 7)) & 1) > 0
        sig = torch.where(occ, sig, 0.0)
    alphas = 1.0 - torch.exp(-dtp[:, None] * cfg.density_scale * sig)
    wgt = alphas * _transmittance(alphas)
    return torch.sum(wgt * z, dim=-1), torch.sum(wgt, dim=-1)


def _transmittance(alphas):
    """Exclusive cumprod of (1 - alpha + 1e-15) along the last axis."""
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1.0 - alphas + 1e-15], dim=-1)
    return torch.cumprod(shifted, dim=-1)[:, :-1]


def _window_grids(pre_dabs, pre_ws, h, w):
    """Per prepass pixel: hit depth where opacity > 0.1, then the 3x3
    [min, max] neighbourhood. Returns ([h, w] each) tmin, tmax, anyhit."""
    t_hit = (pre_dabs / torch.clamp(pre_ws, min=0.1)).reshape(h, w)
    hit_p = (pre_ws > 0.1).reshape(h, w)
    big = 1e9
    tmin = torch.where(hit_p, t_hit, big)
    tmax = torch.where(hit_p, t_hit, -big)
    # max_pool2d pads with -inf, which never wins over the +-big fill
    tmin = -F.max_pool2d(-tmin[None, None], 3, stride=1, padding=1)[0, 0]
    tmax = F.max_pool2d(tmax[None, None], 3, stride=1, padding=1)[0, 0]
    return tmin, tmax, tmin < big


def _window_shade_tile(net, cfg, o, d, ta, tb, nr, fr, ht, K, bg_color,
                       plain=False):
    """Shade one tile of rays with K uniform samples in [ta, tb]. Returns
    (img [T, 3], depth, agg, ws)."""
    T = o.shape[0]
    dtw = (tb - ta) / K
    jj = torch.arange(K, dtype=torch.float32, device=o.device) + 0.5
    z = ta[:, None] + dtw[:, None] * jj[None, :]                   # [T, K]
    mask = ht[:, None] & (z < fr[:, None])
    xyz = torch.clamp(o[:, None, :] + z[..., None] * d[:, None, :],
                      -cfg.bound, cfg.bound).reshape(-1, 3)
    dirs = d[:, None, :].expand(T, K, 3).reshape(-1, 3)
    sigmas, rgbs = net(xyz, dirs, plain=plain)
    sigmas = torch.where(mask, sigmas.reshape(T, K), 0.0)
    rgbs = rgbs.reshape(T, K, 3)
    alphas = 1.0 - torch.exp(-dtw[:, None] * cfg.density_scale * sigmas)
    wgt = alphas * _transmittance(alphas)
    ws = torch.sum(wgt, dim=-1)
    img = torch.sum(wgt[..., None] * rgbs, dim=-2) \
        + (1.0 - ws)[..., None] * bg_color
    safe = torch.where(fr > nr, fr - nr, 1.0)
    depth = torch.sum(wgt * torch.clamp(z - nr[:, None], min=0.0),
                      dim=-1) / safe
    agg = torch.sum(wgt * sigmas, dim=-1)
    return img, depth, agg, ws


def render_frame_guided(net, state: RendererState, rays_o, rays_d, H: int,
                        W: int, prepass_factor: int = 8,
                        max_samples: int = 16, tile: int = 8192,
                        bg_color: float = 1.0, margin_cells: float = 6.0,
                        scout_samples: int = 64, adaptive_k: int = 0,
                        adaptive_span_cells: float = 12.5,
                        plain_field: bool = False):
    """rays_o/d: [H*W, 3] row-major, on the device that renders. Returns
    {'image' [N, 3], 'depth', 'aggregated_density', 'weights_sum' [N],
    'tile_bucket' [n_tiles] int64 numpy: 0 empty, 1 adaptive_k, 2 K}.

    The JAX version's march prepass and "partition" tile order are not
    ported; this is its prepass_mode="scout", fine_order="natural", where
    its tile size is min(tile, natural_tile_cap): `tile` here.
    `plain_field` shades through K1's plain version instead of the kernel
    (for comparing the two frames)."""
    cfg = net.cfg
    dev = rays_o.device
    f = prepass_factor
    K = max_samples
    N = H * W
    if rays_o.shape[0] != N:
        raise ValueError("guided render needs full-frame rays")
    h = (H + f - 1) // f
    w = (W + f - 1) // f
    cell = 2.0 * cfg.bound / cfg.grid_size
    margin = margin_cells * cell
    aabb = aabb_of(cfg, dev)

    # ---- scout prepass: one centre ray per f x f block
    yy = np.clip(np.arange(h) * f + f // 2, 0, H - 1)
    xx = np.clip(np.arange(w) * f + f // 2, 0, W - 1)
    pre_idx = torch.as_tensor((yy[:, None] * W + xx[None, :]).reshape(-1),
                              device=dev)
    pre_dabs, pre_ws = _scout_field(net, rays_o[pre_idx], rays_d[pre_idx],
                                    scout_samples, cfg, aabb,
                                    bitfield=state.density_bitfield,
                                    grid_size=cfg.grid_size)

    # ---- per-ray windows from the 3x3-dilated scout depths
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    tmin, tmax, anyhit = _window_grids(pre_dabs, pre_ws, h, w)

    def up(m):  # nearest-neighbour upsample [h, w] -> [H*W]
        m = m[:, None, :, None].expand(h, f, w, f)
        return m.reshape(h * f, w * f)[:H, :W].reshape(N)

    t0 = torch.minimum(torch.maximum(up(tmin) - margin, nears), fars)
    t1 = torch.minimum(torch.maximum(up(tmax) + margin, nears), fars)
    hit = (up(anyhit.float()) > 0.5) & (fars > nears) & (t1 > t0)

    n_tiles = (N + tile - 1) // tile
    pad = n_tiles * tile - N

    def padded(v, fill):
        if not pad:
            return v
        filler = torch.as_tensor(fill, dtype=v.dtype, device=dev)
        return torch.cat([v, filler.expand((pad,) + v.shape[1:])])

    o_s = padded(rays_o, 0.0).reshape(n_tiles, tile, 3)
    d_s = padded(rays_d, [0.0, 0.0, 1.0]).reshape(n_tiles, tile, 3)
    t0_s = padded(t0, 0.0).reshape(n_tiles, tile)
    t1_s = padded(t1, 0.0).reshape(n_tiles, tile)
    nr_s = padded(nears, 0.0).reshape(n_tiles, tile)
    fr_s = padded(fars, 1.0).reshape(n_tiles, tile)
    hit_s = padded(hit, False).reshape(n_tiles, tile)

    # ---- tile buckets, on the device in one op, to the host in one copy
    any_hit = hit_s.any(dim=1)
    if adaptive_k:
        span = torch.amax(torch.where(hit_s, t1_s - t0_s, 0.0), dim=1)
        bucket = torch.where(span <= adaptive_span_cells * cell, 1, 2)
    else:
        bucket = torch.full_like(any_hit, 2, dtype=torch.int64)
    bucket = torch.where(any_hit, bucket, 0).cpu().numpy()

    img = torch.full((n_tiles, tile, 3), float(bg_color),
                     dtype=torch.float32, device=dev)
    depth = torch.zeros((n_tiles, tile), dtype=torch.float32, device=dev)
    agg = torch.zeros_like(depth)
    ws = torch.zeros_like(depth)
    for i in np.nonzero(bucket)[0]:
        kb = adaptive_k if bucket[i] == 1 else K
        img[i], depth[i], agg[i], ws[i] = _window_shade_tile(
            net, cfg, o_s[i], d_s[i], t0_s[i], t1_s[i], nr_s[i], fr_s[i],
            hit_s[i], kb, bg_color, plain=plain_field)
    return {"image": img.reshape(-1, 3)[:N],
            "depth": depth.reshape(-1)[:N],
            "aggregated_density": agg.reshape(-1)[:N],
            "weights_sum": ws.reshape(-1)[:N],
            "tile_bucket": bucket}
