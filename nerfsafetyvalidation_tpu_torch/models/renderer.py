"""Frame renderers of the port (nerfsafetyvalidation_tpu/models/
renderer.py): the marched frame `render_frame_fast`, the depth-guided frame
`render_frame_guided`, the marched training render `run_grid` and its staged
loop `render_grid_staged` (validate's `--fast_render` observation), the
uniform-sampling render `run` with its staged loop `render` and
`render_tiles` (how the reference's entry points observe a trained NeRF),
and the occupancy state: `RendererState.create`, `mark_untrained_grid` and
the refresh `update_extra_state` (full or partial).

`render_frame_guided` places K uniform samples per ray in a window around
a low-resolution prepass depth: a scout (uniform samples through the
density head, masked by the occupancy bitfield) or the marched fast frame
of the prepass rays. `render_frame_fast` marches every ray through the
occupancy grid, sorts the rays by sample count and shades them in tiles.

The JAX versions map over tiles with `lax.map` and `lax.switch`; here the
tiles are a Python loop. Every tile's bucket is computed on the device in
one tensor op and copied to the host once per frame, so the loop never
waits on the device per tile.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.compositing import composite_weights
from ..ops.marching import (SQRT3, _mip_from_dt, _mip_from_pos,
                            compact_samples, composite_marched,
                            gather_compacted, march_rays, scatter_back)
from ..ops.ray_ops import (morton3d, morton3d_invert, near_far_from_aabb,
                           occupancy_to_skip_grid, packbits, sph_from_ray)
from ..ops.sample_pdf import linspace, sample_pdf


@dataclass
class RendererState:
    """Occupancy state. The scout frame reads only the bitfield; the
    marcher reads the skip grid where there is one; `update_extra_state`
    reads and writes all of it.

    density_bitfield: [cascade * H^3 / 8] uint8, morton order, bit i of
        byte n = cell 8n + i;
    density_grid: [cascade, H^3] float32, morton order, -1 = untrained;
    mean_density: [] float32; iter_density: [] int32;
    skip_grid: [cascade, H^3] uint8, Chebyshev distance to occupied."""
    density_bitfield: torch.Tensor
    density_grid: torch.Tensor = None
    mean_density: torch.Tensor = None
    iter_density: torch.Tensor = None
    skip_grid: torch.Tensor = None

    @staticmethod
    def create(cascade: int, grid_size: int = 128,
               device="cuda") -> "RendererState":
        """An empty state: zero densities, no occupied bit, no skip grid."""
        n = grid_size ** 3
        return RendererState(
            density_bitfield=torch.zeros((cascade * n // 8,),
                                         dtype=torch.uint8, device=device),
            density_grid=torch.zeros((cascade, n), dtype=torch.float32,
                                     device=device),
            mean_density=torch.zeros((), dtype=torch.float32, device=device),
            iter_density=torch.zeros((), dtype=torch.int32, device=device))


def aabb_of(cfg, device):
    b = cfg.bound
    return torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32,
                        device=device)


def _grid_cells(grid_size: int, device, n_blocks: int = 1, block: int = 0):
    """(coords [M, 3] int32, morton indices [M] int64) of the cells a
    refresh probes: all of them, or the morton-strided subset
    block::n_blocks."""
    total = grid_size ** 3
    if n_blocks > 1:
        if total % n_blocks or not 0 <= block < n_blocks:
            raise ValueError(f"cannot probe block {block} of {n_blocks}")
        indices = block + torch.arange(total // n_blocks, dtype=torch.int64,
                                       device=device) * n_blocks
        return morton3d_invert(indices), indices
    g = torch.arange(grid_size, dtype=torch.int32, device=device)
    coords = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                         dim=-1).reshape(-1, 3)
    return coords, morton3d(coords).to(torch.int64)


def mark_untrained_grid(cfg, state: RendererState, poses, intrinsic,
                        grid_size: int = 128) -> RendererState:
    """Mark the cells that no training camera sees as -1
    (renderer.py:388-451). poses: [B, 4, 4] cam2world; intrinsic: (fx, fy,
    cx, cy). The skip grid is dropped, as in the JAX package."""
    grid = state.density_grid
    dev = grid.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    fx, fy, cx, cy = [float(v) for v in intrinsic]
    coords, indices = _grid_cells(grid_size, dev)
    world = 2.0 * coords.float() / (grid_size - 1) - 1.0
    new_grid = grid.clone()
    for cas in range(grid.shape[0]):
        bound = min(2 ** cas, cfg.bound)
        half = bound / grid_size
        pts = world * (bound - half)
        cam = pts[None] - poses[:, None, :3, 3]
        cam = torch.einsum("bmi,bij->bmj", cam, poses[:, :3, :3])
        mz = cam[..., 2] > 0
        mx = torch.abs(cam[..., 0]) < cx / fx * cam[..., 2] + half * 2
        my = torch.abs(cam[..., 1]) < cy / fy * cam[..., 2] + half * 2
        unseen = (mz & mx & my).sum(dim=0) == 0
        new_grid[cas, indices] = torch.where(unseen, -1.0,
                                             grid[cas, indices])
    return RendererState(density_bitfield=state.density_bitfield,
                         density_grid=new_grid,
                         mean_density=state.mean_density,
                         iter_density=state.iter_density)


def update_extra_state(net, state: RendererState, generator=None,
                       jitter=None, decay: float = 0.95,
                       grid_size: int = 128, n_blocks: int = 1,
                       block: int = 0) -> RendererState:
    """Refresh the density grid, bitfield and skip grid from the field
    (renderer.py:453-546): every probed cell centre of every cascade,
    jittered by up to half a cell, goes through `net.density` in one batch;
    those cells decay by `decay` and take the max with the new density.
    n_blocks = 1 probes every cell; n_blocks > 1 only the morton-strided
    subset block::n_blocks (the partial update), leaving the rest as they
    are.

    The jitter is uniform in [0, 1) per probed cell and axis: drawn from
    `generator`, or handed in as `jitter` ([cascade][M, 3] tensors), as
    the tests hand in the JAX package's own draws."""
    cfg = net.cfg
    grid = state.density_grid
    dev = grid.device
    cascade = grid.shape[0]
    coords, indices = _grid_cells(grid_size, dev, n_blocks, block)
    xyzs = 2.0 * coords.float() / (grid_size - 1) - 1.0

    tmp = -torch.ones_like(grid)
    for cas in range(cascade):
        bound = min(2 ** cas, cfg.bound)
        half = bound / grid_size
        u = jitter[cas] if jitter is not None else torch.rand(
            xyzs.shape, generator=generator, device=dev)
        pts = xyzs * (bound - half) + (u.to(dev) * 2.0 - 1.0) * half
        tmp[cas, indices] = net.density(pts)["sigma"] * cfg.density_scale

    valid = (grid >= 0) & (tmp >= 0)
    new_grid = torch.where(valid, torch.maximum(grid * decay, tmp), grid)
    mean_density = torch.mean(torch.clamp(new_grid, min=0.0))
    thresh = torch.clamp(mean_density, max=cfg.density_thresh)
    return RendererState(
        density_bitfield=packbits(new_grid, thresh), density_grid=new_grid,
        mean_density=mean_density, iter_density=state.iter_density + 1,
        skip_grid=occupancy_to_skip_grid(new_grid > thresh, grid_size))


def run_grid(net, state: RendererState, rays_o, rays_d,
             max_samples: int = 64, max_steps: int = 1024,
             dt_gamma: float = 0.0, bg_color=None, perturb=None,
             density_scale: float = None, sample_budget: int = None,
             samples_per_hit: int = 1):
    """The occupancy-marched render of training (the JAX run_grid):
    march up to `max_samples` samples a ray (perturbed by `perturb`, see
    `march_rays`), query the field once, composite. With `sample_budget`
    only the real samples are queried: the first `sample_budget` of them
    in ray order go to a compact buffer of (t, ray) rows, from which the
    positions are rebuilt, and the field's (sigma, rgb) rows come back
    through one gather; the rest count as empty. The JAX version queries
    every row of the buffer, the unused ones at (t = 0, ray 0), and drops
    their outputs; here the buffer is cut to its used rows (one wait for
    the device), which gives the same values and keeps thousands of copies
    of one position out of the gathers' backward. rays_o/d: [N, 3].
    Returns {'image' [N, 3], 'depth', 'weights_sum', 'aggregated_density',
    'depth_abs' [N], 'rgbs' [N, K, 3], 'sigmas' [N * K, 1]}."""
    cfg = net.cfg
    if density_scale is None:
        density_scale = cfg.density_scale
    dev = rays_o.device
    N = rays_o.shape[0]
    K = max_samples
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb_of(cfg, dev),
                                     cfg.min_near)
    m = march_rays(rays_o, rays_d, nears, fars, state.density_bitfield,
                   cfg.bound, cfg.cascade, cfg.grid_size,
                   max_samples=K, max_steps=max_steps, dt_gamma=dt_gamma,
                   perturb=perturb, skip_grid=state.skip_grid,
                   samples_per_hit=samples_per_hit)
    mask = m["mask"]
    if sample_budget is not None:
        dest, kept, n_valid = compact_samples(mask, sample_budget)
        ray_ids = torch.arange(N, dtype=torch.float32,
                               device=dev)[:, None].expand(N, K)
        pc = gather_compacted(torch.stack([m["ts"], ray_ids], dim=-1), dest,
                              sample_budget)                     # [B, 2]
        pc = pc[:min(int(n_valid), sample_budget)]
        rid = pc[:, 1].to(torch.int64)
        o_c, d_c = rays_o[rid], rays_d[rid]
        xs = torch.clamp(o_c + pc[:, :1] * d_c, -cfg.bound, cfg.bound)
        sig_c, rgb_c = net(xs, d_c)
        back = scatter_back(torch.cat([sig_c[:, None], rgb_c], dim=-1),
                            dest, (N, K))                        # [N, K, 4]
        sigmas, rgbs = back[..., 0], back[..., 1:]
        mask = mask & kept
    else:
        dirs = rays_d[:, None, :].expand(N, K, 3).reshape(-1, 3)
        sigmas, rgbs = net(m["xyzs"].reshape(-1, 3), dirs)
        sigmas, rgbs = sigmas.reshape(N, K), rgbs.reshape(N, K, 3)

    res = composite_marched(sigmas, rgbs, m["deltas"], m["rs"], m["ts"],
                            mask, nears, fars, density_scale=density_scale)
    bg = 1.0 if bg_color is None else bg_color
    safe = torch.where(fars > nears, fars - nears, 1.0)
    return {"image": res["image"] + (1.0 - res["weights_sum"])[..., None]
            * bg,
            "depth": torch.clamp(res["depth"] - nears, min=0.0) / safe,
            "weights_sum": res["weights_sum"], "rgbs": rgbs,
            "sigmas": sigmas.reshape(-1, 1),
            "aggregated_density": res["aggregated_density"],
            "depth_abs": res["depth_abs"]}


def render_grid_staged(net, state: RendererState, rays_o, rays_d,
                       max_ray_batch: int = 4096, max_samples: int = 32,
                       max_steps: int = 512, dt_gamma: float = 0.0,
                       bg_color=None):
    """The staged occupancy-marched frame (renderer.py:393-445), the
    observation render of validate's `--fast_render`: chunks of
    max_ray_batch rays, the last one padded with the JAX package's filler
    rays (`_pad_rays`), each through `run_grid` with a sample budget of
    12 * max_ray_batch (the budget is per chunk, so the chunking is
    part of the result). rays_o/d: [B, N, 3]. 'image', 'depth' and
    'aggregated_density' cover every ray; 'rgbs' and 'sigmas' are the last
    chunk's, padding included (the reference's contract, which the UQ
    reads)."""
    bg = 1.0 if bg_color is None else bg_color
    return _staged(
        lambda ro, rd: run_grid(net, state, ro, rd, max_samples=max_samples,
                                max_steps=max_steps, dt_gamma=dt_gamma,
                                bg_color=bg,
                                sample_budget=max_ray_batch * 12),
        rays_o, rays_d, max_ray_batch)


def _staged(render_chunk, rays_o, rays_d, max_ray_batch):
    """The staged loop of `render` and `render_grid_staged`: rays_o/d
    [B, N, 3] in chunks of max_ray_batch rays, the last one padded
    (`_pad_rays`), each through render_chunk(rays_o, rays_d); 'image',
    'depth' and 'aggregated_density' of every ray, written into tensors
    on the rays' device (nothing waits on the device per chunk), and the
    last chunk's 'rgbs' and 'sigmas'."""
    B, N = rays_o.shape[:2]
    dev = rays_o.device
    depth = torch.empty((B, N), device=dev)
    image = torch.empty((B, N, 3), device=dev)
    aggregated = torch.empty((B, N), device=dev)
    last = None
    for b in range(B):
        for head in range(0, N, max_ray_batch):
            tail = min(head + max_ray_batch, N)
            ro, rd = _pad_rays(rays_o[b, head:tail], rays_d[b, head:tail],
                               max_ray_batch)
            last = render_chunk(ro, rd)
            n = tail - head
            depth[b, head:tail] = last["depth"][:n]
            image[b, head:tail] = last["image"][:n]
            aggregated[b, head:tail] = last["aggregated_density"][:n]
    return {"depth": depth, "image": image, "rgbs": last["rgbs"],
            "sigmas": last["sigmas"], "aggregated_density": aggregated}


def _pad_rays(rays_o, rays_d, n):
    """Pad to n rays with the JAX package's filler: origin 0, dir +z."""
    pad = n - rays_o.shape[0]
    if not pad:
        return rays_o, rays_d
    dev = rays_o.device
    fill_d = torch.zeros((pad, 3), device=dev)
    fill_d[:, 2] = 1.0            # made on the device: no copy from the host
    return (torch.cat([rays_o, torch.zeros((pad, 3), device=dev)]),
            torch.cat([rays_d, fill_d]))


def _uq_moments(rgbs, sigmas):
    """The Gaussian UQ's sample moments [S_c2d2, S_cd, S_d, S_d2] of one
    tile: sums of (c sigma)^2, c sigma, sigma and sigma^2 over its slots
    (rgbs [T, K, 3]; sigmas [T, K], 0 in the slots the tile masks out)."""
    cd = rgbs * sigmas[..., None]
    return torch.stack([torch.sum(cd * cd), torch.sum(cd), torch.sum(sigmas),
                        torch.sum(sigmas ** 2)])


def _shade_marched_tile(net, cfg, o, d, ts, count, nr, fr, Kb, dt_min,
                        dt_max, dt_gamma, bg_color, plain=False,
                        moments=False):
    """Shade one sorted tile's first Kb sample slots and composite them.
    Returns (img [T, 3], depth, agg, ws, depth_abs, the tile's UQ moments
    (masked slots as sigma = 0) or None)."""
    T = o.shape[0]
    ts = ts[:, :Kb]
    mask = torch.arange(Kb, device=o.device)[None, :] < count[:, None]
    dts = torch.clamp(ts * dt_gamma, dt_min, dt_max) * mask
    ends = ts + dts
    rs = (ends - torch.cat([nr[:, None], ends[:, :-1]], dim=1)) * mask
    xyzs = torch.clamp(o[:, None, :] + ts[..., None] * d[:, None, :],
                       -cfg.bound, cfg.bound).reshape(-1, 3)
    dirs = d[:, None, :].expand(T, Kb, 3).reshape(-1, 3)
    sigmas, rgbs = net(xyzs, dirs, plain=plain)
    sigmas, rgbs = sigmas.reshape(T, Kb), rgbs.reshape(T, Kb, 3)
    res = composite_marched(sigmas, rgbs, dts, rs, ts, mask, nr, fr,
                            density_scale=cfg.density_scale)
    ws = res["weights_sum"]
    img = res["image"] + (1.0 - ws)[..., None] * bg_color
    safe = torch.where(fr > nr, fr - nr, 1.0)
    depth = torch.clamp(res["depth"] - nr, min=0.0) / safe
    mom = _uq_moments(rgbs, torch.where(mask, sigmas, 0.0)) if moments \
        else None
    return img, depth, res["aggregated_density"], ws, res["depth_abs"], mom


def render_frame_fast(net, state: RendererState, rays_o, rays_d,
                      tile: int = 131072, max_samples: int = 16,
                      max_steps: int = 512, dt_gamma: float = 0.0,
                      bg_color: float = 1.0, samples_per_hit: int = 2,
                      march_tile: int = 32768, return_moments: bool = False,
                      plain_field: bool = False):
    """Marched frame: march every ray, sort the rays by sample count, shade
    the sorted rays in tiles at the smallest sufficient slot count (4, 8 or
    K), skip tiles without samples, and unsort.

    Phase 1 marches every ray exactly 24 iterations. The rays are then
    sorted, stably, unfinished first and then by sample count; phase 2
    resumes only the unfinished prefix, for up to `max_steps` more
    iterations (the JAX version runs it per 32,768-ray march tile; the
    result is the same, since the loop is a no-op for a finished ray), so
    `march_tile`, the JAX version's march tile, is accepted and changes
    nothing. Rays are padded to a whole number of tiles as in the JAX
    version. `samples_per_hit` samples are emitted a step (2 pairs them).

    Returns {'image' [N, 3], 'depth', 'aggregated_density', 'weights_sum',
    'depth_abs' [N], 'tile_bucket' [n_tiles] int64 numpy: 0 empty, b > 0
    shaded with the b-th of the slot counts (4, 8, K), 'march' (phase-1
    iterations, rays unfinished after them, phase-2 iterations)}, and
    with `return_moments` 'uq_moments' [4]: [S_c2d2, S_cd, S_d, S_d2], the
    sums of (c sigma)^2, c sigma, sigma and sigma^2 over every shaded slot
    of every tile, a masked slot counting as sigma = 0 (what the batched
    engines' Gaussian UQ reads).
    `plain_field` shades through the field's plain version instead of its
    kernel."""
    cfg = net.cfg
    dev = rays_o.device
    N0 = rays_o.shape[0]
    n_tiles = (N0 + tile - 1) // tile
    N = n_tiles * tile
    K = max_samples
    rays_o, rays_d = _pad_rays(rays_o, rays_d, N)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb_of(cfg, dev),
                                     cfg.min_near)
    march = dict(bitfield=state.density_bitfield, bound=cfg.bound,
                 cascade=cfg.cascade, grid_size=cfg.grid_size,
                 max_samples=K, max_steps=max_steps, dt_gamma=dt_gamma,
                 skip_grid=state.skip_grid, samples_per_hit=samples_per_hit)

    # ---- phase 1: a fixed budget of iterations for every ray
    p1, (t_c, count_c, ts_c) = march_rays(
        rays_o, rays_d, nears, fars, fixed_iters=min(24, max_steps),
        return_carry=True, **march)

    # ---- stable sort: unfinished rays first, then by sample count
    active = (t_c < fars) & (count_c < K)
    key_desc = (2 * K + 1) - (active.to(torch.int32) * (K + 1) + count_c)
    order = torch.sort(key_desc, stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(N, device=dev)       # the inverse permutation
    o_s, d_s = rays_o[order], rays_d[order]
    nr_s, fr_s = nears[order], fars[order]
    t_s, count_s, ts_s = t_c[order], count_c[order], ts_c[order]

    # ---- phase 2 on the unfinished prefix only
    n_active = int(active.sum())
    iters = [p1["iters"], 0]
    if n_active:
        a = slice(0, n_active)
        out = march_rays(o_s[a], d_s[a], nr_s[a], fr_s[a],
                         resume_carry=(t_s[a], count_s[a], ts_s[a]),
                         **march)
        ts_s = torch.cat([out["ts"], ts_s[n_active:]])
        count_s = torch.cat([out["count"], count_s[n_active:]])
        iters[1] = out["iters"]

    # ---- count-bucketed shading: a tile's max count bounds all its rays
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cfg.cascade - 1)) / cfg.grid_size
    sizes = [k for k in (4, 8) if k < K] + [K]
    mx = count_s.reshape(n_tiles, tile).amax(dim=1)
    bucket = (mx > 0).to(torch.int64)
    for b in sizes[:-1]:
        bucket = bucket + (mx > b).to(torch.int64)
    bucket = bucket.cpu().numpy()

    img = torch.full((N, 3), float(bg_color), dtype=torch.float32,
                     device=dev)
    depth = torch.zeros((N,), dtype=torch.float32, device=dev)
    agg, ws, dabs = (torch.zeros_like(depth) for _ in range(3))
    moms = []
    for i in np.nonzero(bucket)[0]:
        r = slice(i * tile, (i + 1) * tile)
        img[r], depth[r], agg[r], ws[r], dabs[r], mom = _shade_marched_tile(
            net, cfg, o_s[r], d_s[r], ts_s[r], count_s[r], nr_s[r], fr_s[r],
            sizes[bucket[i] - 1], dt_min, dt_max, dt_gamma, bg_color,
            plain=plain_field, moments=return_moments)
        moms.append(mom)
    out = {"image": img[pos][:N0], "depth": depth[pos][:N0],
           "aggregated_density": agg[pos][:N0],
           "weights_sum": ws[pos][:N0], "depth_abs": dabs[pos][:N0],
           "tile_bucket": bucket, "march": (iters[0], n_active, iters[1])}
    if return_moments:
        out["uq_moments"] = _sum_moments(moms, dev)
    return out


def _sum_moments(moms, device):
    """The frame's moments: the shaded tiles' summed in tile order (an
    empty tile adds nothing)."""
    if not moms:
        return torch.zeros((4,), dtype=torch.float32, device=device)
    return torch.stack(moms).sum(dim=0)


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
                       plain=False, moments=False):
    """Shade one tile of rays with K uniform samples in [ta, tb]. Returns
    (img [T, 3], depth, agg, ws, the tile's UQ moments or None)."""
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
    return img, depth, agg, ws, _uq_moments(rgbs, sigmas) if moments \
        else None


def render_frame_guided(net, state: RendererState, rays_o, rays_d, H: int,
                        W: int, prepass_factor: int = 8,
                        max_samples: int = 16, tile: int = 8192,
                        bg_color: float = 1.0, margin_cells: float = 6.0,
                        scout_samples: int = 64, adaptive_k: int = 0,
                        adaptive_span_cells: float = 12.5,
                        prepass_mode: str = "march", prepass_net=None,
                        max_steps: int = 512, dt_gamma: float = 1.0 / 64,
                        return_moments: bool = False,
                        plain_field: bool = False):
    """rays_o/d: [H*W, 3] row-major, on the device that renders. Returns
    {'image' [N, 3], 'depth', 'aggregated_density', 'weights_sum' [N],
    'tile_bucket' [n_tiles] int64 numpy: 0 empty, 1 adaptive_k, 2 K,
    'march': the march prepass's iteration counts (render_frame_fast), or
    None}, and with `return_moments` 'uq_moments' [4] as render_frame_fast
    gives them, over the fine pass's shaded slots (the prepass adds
    none).

    prepass_mode "scout" finds each block's depth with `scout_samples`
    uniform samples through the prepass net's density head, masked by the
    bitfield; "march" (the default, as in the JAX version) renders the
    prepass rays with `render_frame_fast` (tile min(16384, prepass rays
    rounded up to 1024), K samples, `max_steps`, `dt_gamma`, paired
    emission), the JAX version's defaults. The prepass net defaults to
    `net`; it holds its own weights, so the JAX version's separate
    prepass_params has no counterpart. The "partition" tile order is not
    ported: tiles are raster order, of `tile` rays (the JAX version's
    min(tile, natural_tile_cap)). `plain_field` shades (and marches the
    prepass) through the fields' plain versions instead of their kernels,
    for comparing the two frames."""
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
    p_net = net if prepass_net is None else prepass_net

    # ---- prepass: one centre ray per f x f block
    yy = np.clip(np.arange(h) * f + f // 2, 0, H - 1)
    xx = np.clip(np.arange(w) * f + f // 2, 0, W - 1)
    pre_idx = torch.as_tensor((yy[:, None] * W + xx[None, :]).reshape(-1),
                              device=dev)
    march = None
    if prepass_mode == "scout":
        pre_dabs, pre_ws = _scout_field(p_net, rays_o[pre_idx],
                                        rays_d[pre_idx], scout_samples, cfg,
                                        aabb, bitfield=state.density_bitfield,
                                        grid_size=cfg.grid_size)
    elif prepass_mode == "march":
        pre = render_frame_fast(
            p_net, state, rays_o[pre_idx], rays_d[pre_idx],
            tile=min(16384, (h * w + 1023) // 1024 * 1024),
            max_samples=K, max_steps=max_steps, dt_gamma=dt_gamma,
            bg_color=bg_color, plain_field=plain_field)
        pre_dabs, pre_ws = pre["depth_abs"], pre["weights_sum"]
        march = pre["march"]
    else:
        raise ValueError(f"unknown prepass_mode {prepass_mode!r}")

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
    moms = []
    for i in np.nonzero(bucket)[0]:
        kb = adaptive_k if bucket[i] == 1 else K
        img[i], depth[i], agg[i], ws[i], mom = _window_shade_tile(
            net, cfg, o_s[i], d_s[i], t0_s[i], t1_s[i], nr_s[i], fr_s[i],
            hit_s[i], kb, bg_color, plain=plain_field,
            moments=return_moments)
        moms.append(mom)
    out = {"image": img.reshape(-1, 3)[:N],
           "depth": depth.reshape(-1)[:N],
           "aggregated_density": agg.reshape(-1)[:N],
           "weights_sum": ws.reshape(-1)[:N],
           "tile_bucket": bucket, "march": march}
    if return_moments:
        out["uq_moments"] = _sum_moments(moms, dev)
    return out


# --------------------------------------------------------------------------
# uniform-sampling render (the JAX package's renderer.py:85-310)
# --------------------------------------------------------------------------

def run(net, rays_o, rays_d, num_steps: int = 128, upsample_steps: int = 128,
        bg_color=None, perturb: bool = False, generator=None,
        training: bool = False, aabb=None, draws=None,
        plain_field: bool = False):
    """Uniform samples along each ray, optionally refined by hierarchical
    upsampling, one dense field query, composited (renderer.py:85-195)
    over the background net where cfg.bg_radius > 0, else over bg_color
    (white by default).
    rays_o/d: [N, 3]. Returns {'depth' [N], 'image' [N, 3], 'weights_sum'
    [N], 'rgbs' [N, T, 3], 'sigmas' [N * T, 1], 'aggregated_density'
    [N]}.

    The random draws (the jitter of perturb=True, the pdf's uniforms when
    `training`) come from `generator`, or from `draws` {'perturb': [N,
    num_steps], 'pdf': [N, upsample_steps]}, as the tests hand in the JAX
    package's own. `aabb` overrides the config's box; `plain_field` shades
    through the plain version of the net's kernel (K4) even on the card."""
    cfg = net.cfg
    dev = rays_o.device
    draws = draws or {}
    aabb = aabb_of(cfg, dev) if aabb is None else torch.as_tensor(
        aabb, dtype=torch.float32, device=dev)
    kw = {"plain": True} if plain_field else {}
    N = rays_o.shape[0]

    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    nears, fars = nears[:, None], fars[:, None]
    z_vals = nears + (fars - nears) * linspace(0.0, 1.0, num_steps,
                                               device=dev)[None, :]
    sample_dist = (fars - nears) / num_steps                 # [N, 1]
    if perturb:
        u = draws.get("perturb")
        if u is None:
            if generator is None:
                raise ValueError("perturb=True needs a generator or "
                                 "draws['perturb']")
            u = torch.rand(z_vals.shape, generator=generator, device=dev)
        z_vals = z_vals + (u - 0.5) * sample_dist

    def make_xyzs(zv):
        x = rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None]
        return torch.minimum(torch.maximum(x, aabb[:3]), aabb[3:])

    def deltas_of(zv):
        return torch.cat([torch.diff(zv, dim=-1),
                          sample_dist.expand(N, 1)], dim=-1)

    dout = net.density(make_xyzs(z_vals).reshape(-1, 3), **kw)
    sigmas = dout["sigma"].reshape(N, num_steps)
    geo_feat = dout["geo_feat"].reshape(N, num_steps, -1)

    total = num_steps
    if upsample_steps > 0:
        # hierarchical upsampling (renderer.py:171-204), no gradient
        # through the pdf
        with torch.no_grad():
            deltas = deltas_of(z_vals)
            weights, _ = composite_weights(sigmas, deltas, cfg.density_scale)
            z_mid = z_vals[..., :-1] + 0.5 * deltas[..., :-1]
            new_z = sample_pdf(z_mid, weights[:, 1:-1], upsample_steps,
                               det=not training, u=draws.get("pdf"),
                               generator=generator)
        ndout = net.density(make_xyzs(new_z).reshape(-1, 3), **kw)
        new_sigmas = ndout["sigma"].reshape(N, upsample_steps)
        new_geo = ndout["geo_feat"].reshape(N, upsample_steps, -1)

        # the stable merge of the coarse and fine samples (jnp.argsort);
        # the positions are not needed past the field queries
        z_vals, order = torch.sort(torch.cat([z_vals, new_z], dim=1),
                                   dim=1, stable=True)
        sigmas = torch.gather(torch.cat([sigmas, new_sigmas], dim=1), 1,
                              order)
        geo_feat = torch.gather(
            torch.cat([geo_feat, new_geo], dim=1), 1,
            order[..., None].expand(-1, -1, geo_feat.shape[-1]))
        total = num_steps + upsample_steps

    weights, _ = composite_weights(sigmas, deltas_of(z_vals),
                                   cfg.density_scale)
    dirs = rays_d[:, None, :].expand(N, total, 3)
    mask = weights > 1e-4           # the reference's threshold
    rgbs = net.color(dirs.reshape(-1, 3),
                     geo_feat.reshape(-1, geo_feat.shape[-1]),
                     mask=mask.reshape(-1), **kw).reshape(N, total, 3)

    weights_sum = weights.sum(dim=-1)
    # miss rays (nears == fars == f32 max) get depth 0, not 0/0
    span = torch.where(fars > nears, fars - nears, 1.0)
    ori_z = torch.clamp((z_vals - nears) / span, 0.0, 1.0)
    depth = (weights * ori_z).sum(dim=-1)
    image = (weights[..., None] * rgbs).sum(dim=-2)
    if cfg.bg_radius > 0:
        # the background net, in place of any colour given
        # (renderer.py:173-179)
        bg = net.background(sph_from_ray(rays_o, rays_d, cfg.bg_radius),
                            rays_d)
    else:
        bg = 1.0 if bg_color is None else bg_color
    image = image + (1.0 - weights_sum)[..., None] * bg
    return {
        "depth": depth,
        "image": image,
        "weights_sum": weights_sum,
        "rgbs": rgbs,
        "sigmas": sigmas.reshape(-1, 1),
        "aggregated_density": (weights * sigmas).sum(dim=-1),
    }


def render(net, rays_o, rays_d, staged: bool = False,
           max_ray_batch: int = 4096, num_steps: int = 512,
           upsample_steps: int = 0, bg_color=None, perturb: bool = False,
           generator=None, training: bool = False,
           plain_field: bool = False):
    """rays_o/d: [B, N, 3] (renderer.py:223-276). Staged: `run` over
    chunks of max_ray_batch rays, the last one padded with origin 0 and
    direction +z, as the JAX package pads it; 'image', 'depth' and
    'aggregated_density' are whole, 'rgbs' and 'sigmas' those of the last
    (padded) chunk, the reference's quirk. The chunks' results are written
    into tensors on the rays' device: nothing waits on the device per
    chunk. Unstaged: one `run` over every ray, with 'weights_sum' too.
    Random draws (perturb, training) come from `generator`."""
    B, N = rays_o.shape[:2]
    dev = rays_o.device
    bg = torch.as_tensor(1.0 if bg_color is None else bg_color,
                         dtype=torch.float32, device=dev)
    kw = dict(num_steps=num_steps, upsample_steps=upsample_steps,
              bg_color=bg, perturb=perturb, generator=generator,
              training=training, aabb=aabb_of(net.cfg, dev),
              plain_field=plain_field)
    if not staged:
        res = run(net, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), **kw)
        return {
            "depth": res["depth"].reshape(B, N),
            "image": res["image"].reshape(B, N, 3),
            "weights_sum": res["weights_sum"].reshape(B, N),
            "rgbs": res["rgbs"],
            "sigmas": res["sigmas"],
            "aggregated_density": res["aggregated_density"].reshape(B, N),
        }
    return _staged(lambda ro, rd: run(net, ro, rd, **kw), rays_o, rays_d,
                   max_ray_batch)


def render_tiles(net, rays_o, rays_d, tile: int = 8192, num_steps: int = 512,
                 upsample_steps: int = 0, bg_color=None):
    """A whole frame in fixed tiles of `tile` rays, only the per-ray
    outputs kept (renderer.py:279-310). rays_o/d: [N, 3]."""
    N = rays_o.shape[0]
    n_tiles = -(-N // tile)
    ro, rd = _pad_rays(rays_o, rays_d, n_tiles * tile)
    dev = rays_o.device
    aabb = aabb_of(net.cfg, dev)
    image = torch.empty((n_tiles * tile, 3), device=dev)
    depth = torch.empty((n_tiles * tile,), device=dev)
    aggregated = torch.empty((n_tiles * tile,), device=dev)
    for t in range(n_tiles):
        sl = slice(t * tile, (t + 1) * tile)
        res = run(net, ro[sl], rd[sl], num_steps=num_steps,
                  upsample_steps=upsample_steps, bg_color=bg_color,
                  aabb=aabb)
        image[sl] = res["image"]
        depth[sl] = res["depth"]
        aggregated[sl] = res["aggregated_density"]
    return {"image": image[:N], "depth": depth[:N],
            "aggregated_density": aggregated[:N]}
