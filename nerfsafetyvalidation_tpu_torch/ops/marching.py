"""Occupancy-grid ray marching and the marched composite
(nerfsafetyvalidation_tpu/ops/marching.py).

`march_rays` walks every ray through the cascaded occupancy bitfield (or
its Chebyshev skip grid) with dt = clamp(t * dt_gamma, dt_min, dt_max),
writing up to K sample start times per ray into a fixed [N, K] slot buffer.
The JAX version is a `lax.while_loop` over all rays; here it is a Python
loop of tensor ops over all rays. The loop body is a no-op for a finished
ray, so running more iterations than a ray needs changes nothing: the loop
asks the device whether any ray is still active only every `CHECK_EVERY`
iterations (each ask waits for the device), and never runs more than
`max_steps`.

`compact_samples`, `gather_compacted` and `scatter_back` move the marched
samples into a fixed budget of rows and back, in the deterministic
prefix-sum layout of the JAX package (the training render queries only the
real samples).
"""

import numpy as np
import torch

from .ray_ops import morton3d

SQRT3 = float(np.sqrt(3.0))
CHECK_EVERY = 8


def _mip_from_pos(pos, cascade: int):
    """Smallest cascade whose [-2^l, 2^l] box contains pos."""
    mx = torch.amax(torch.abs(pos), dim=-1)
    lvl = torch.ceil(torch.log2(torch.clamp(mx, min=1e-8)))
    return torch.clamp(lvl, 0, cascade - 1).to(torch.int32)


def _mip_from_dt(dt, grid_size: int, cascade: int):
    """Cascade whose cell size (2 * 2^l / H) covers dt."""
    lvl = torch.ceil(torch.log2(torch.clamp(dt * grid_size / 2.0, min=1e-8)))
    return torch.clamp(lvl, 0, cascade - 1).to(torch.int32)


def march_rays(rays_o, rays_d, nears, fars, bitfield, bound: float,
               cascade: int, grid_size: int = 128, max_samples: int = 64,
               max_steps: int = 1024, dt_gamma: float = 0.0, perturb=None,
               skip_grid=None, samples_per_hit: int = 1, fixed_iters=None,
               resume_carry=None, return_carry: bool = False):
    """Up to `max_samples` occupied-space samples per ray.

    Returns {'xyzs' [N, K, 3], 'deltas' [N, K] (dt), 'rs' [N, K] (depth
    step), 'ts' [N, K], 'mask' [N, K] bool, 'count' [N], 'iters' (loop
    iterations run, an int)}. `fixed_iters`
    runs exactly that many iterations; `return_carry` also returns the
    carry (t, count, ts), and `resume_carry` continues from one. Rays may
    be permuted between phases as long as their carry rows travel with
    them. `samples_per_hit=2` also emits the next dt sample of an occupied
    cell in the same iteration, without re-checking occupancy. `perturb`
    starts each ray at near + dt_min * u, u uniform in [0, 1): a
    torch.Generator to draw u from, or u itself ([N] tensor), as the tests
    hand in the JAX package's draws."""
    N = rays_o.shape[0]
    K = max_samples
    H = grid_size
    dev = rays_o.device
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cascade - 1)) / H
    slot = torch.arange(K, device=dev)[None, :]
    skip_flat = None if skip_grid is None else skip_grid.reshape(-1)
    half_sign = 0.5 * torch.sign(rays_d)

    t0 = nears
    if isinstance(perturb, torch.Generator):
        t0 = nears + dt_min * torch.rand(nears.shape, generator=perturb,
                                         device=dev)
    elif perturb is not None:
        t0 = nears + dt_min * perturb
    if resume_carry is not None:
        t, count, ts = resume_carry
    else:
        t = t0
        count = torch.zeros((N,), dtype=torch.int32, device=dev)
        ts = torch.zeros((N, K), dtype=torch.float32, device=dev)

    def body(t, count, ts):
        pos = torch.clamp(rays_o + t[:, None] * rays_d, -bound, bound)
        dt = torch.clamp(t * dt_gamma, dt_min, dt_max)
        level = torch.maximum(_mip_from_pos(pos, cascade),
                              _mip_from_dt(dt, H, cascade))
        mip_bound = torch.clamp(torch.exp2(level.float()), max=bound)
        nxyz = torch.clamp(0.5 * (pos * (1.0 / mip_bound)[:, None] + 1.0) * H,
                           0.0, H - 1).to(torch.int32)
        index = level.to(torch.int64) * H ** 3 + morton3d(nxyz).to(
            torch.int64)
        if skip_flat is not None:
            skip = skip_flat[index]
            occ = skip == 0
        else:
            byte = bitfield[index >> 3].to(torch.int64)
            occ = ((byte >> (index & 7)) & 1) > 0

        active = (t < fars) & (count < K)
        emit = occ & active
        new_t = t + dt
        if samples_per_hit == 2:
            dt2 = torch.clamp(new_t * dt_gamma, dt_min, dt_max)
            emit2 = emit & (new_t < fars) & (count + 1 < K)
            off = slot - count[:, None]
            write = emit[:, None] & ((off == 0)
                                     | (emit2[:, None] & (off == 1)))
            ts = torch.where(write, torch.where(off == 0, t[:, None],
                                                new_t[:, None]), ts)
            count = count + emit.to(torch.int32) + emit2.to(torch.int32)
            new_t = torch.where(emit2, new_t + dt2, new_t)
        else:
            onehot = (slot == count[:, None]) & emit[:, None]
            ts = torch.where(onehot, t[:, None], ts)
            count = count + emit.to(torch.int32)

        # empty cell: jump to the next voxel boundary
        cell = (nxyz.float() + 0.5 + half_sign) * (2.0 / H) - 1.0
        t_exit = (cell * mip_bound[:, None] - pos) / rays_d
        tt = t + torch.clamp(torch.amin(t_exit, dim=-1), min=0.0)
        if skip_flat is not None:   # (skip - 1) cell widths are free
            tt = torch.maximum(tt, t + (skip.float() - 1.0)
                               * (2.0 * mip_bound / H))
        skip_t = torch.maximum(new_t, tt)
        t = torch.where(active, torch.where(emit, new_t, skip_t), t)
        return t, count, ts

    iters = 0
    while iters < (max_steps if fixed_iters is None else fixed_iters):
        if fixed_iters is None and iters % CHECK_EVERY == 0 and not bool(
                ((t < fars) & (count < K)).any()):
            break
        t, count, ts = body(t, count, ts)
        iters += 1

    mask = slot < count[:, None]
    dts = torch.clamp(ts * dt_gamma, dt_min, dt_max) * mask
    ends = ts + dts
    # rs telescopes from the ray's march start
    rs = (ends - torch.cat([t0[:, None], ends[:, :-1]], dim=1)) * mask
    xyzs = torch.clamp(rays_o[:, None, :] + ts[..., None]
                       * rays_d[:, None, :], -bound, bound)
    out = {"xyzs": xyzs, "deltas": dts, "rs": rs, "ts": ts, "mask": mask,
           "count": count, "iters": iters}
    if return_carry:
        return out, (t, count, ts)
    return out


def compact_samples(mask, budget: int):
    """Map the True entries of mask [N, K], in row-major order, to the
    slots of a [budget] buffer, dropping the overflow. Returns (dest [N, K]
    int64: the sample's slot, `budget` where masked or dropped; kept
    [N, K] bool; n_valid [] int64)."""
    flat = mask.reshape(-1)
    pos = torch.cumsum(flat.to(torch.int64), dim=0) - 1
    dest = torch.where(flat & (pos < budget), pos, budget)
    return (dest.reshape(mask.shape), (dest < budget).reshape(mask.shape),
            flat.sum())


def gather_compacted(values, dest, budget: int, fill=0.0):
    """Per-sample values [N, K, ...] into the compact [budget, ...] buffer;
    an extra trash row takes the dropped samples."""
    v = values.reshape((-1,) + values.shape[2:])
    out = torch.full((budget + 1,) + v.shape[1:], fill, dtype=values.dtype,
                     device=values.device)
    out[dest.reshape(-1)] = v
    return out[:budget]


def scatter_back(compact, dest, shape):
    """Each sample's compact row back to [*shape, ...]; samples whose slot
    is not a row of `compact` (masked, dropped, or past a buffer cut to
    its used rows) read zeros.

    The JAX version reads every sample's row from the buffer with a zero
    trash row appended, whose backward is a scatter-add in which every
    masked sample hits the trash row. On the card PyTorch's scatter-add
    runs each index's duplicates in one thread, so here the kept samples'
    rows are put into a zero tensor instead: the same values, and a
    backward that only gathers."""
    flat = dest.reshape(-1)
    pos = torch.nonzero(flat < compact.shape[0]).squeeze(1)
    out = compact.new_zeros((flat.shape[0],) + compact.shape[1:])
    out = out.index_put((pos,), compact[flat[pos]])
    return out.reshape(tuple(shape) + compact.shape[1:])


def composite_marched(sigmas, rgbs, deltas, rs, ts, mask, nears, fars,
                      density_scale: float = 1.0):
    """Composite marched samples; masked slots contribute nothing
    (raymarching.cu:505-593). `depth` keeps the JAX package's quirk
    verbatim (the cumulative rs depth, near-relative, and the caller
    subtracts near again); `depth_abs` is the opacity-weighted sample t."""
    sigmas = torch.where(mask, sigmas, 0.0)
    alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                         1.0 - alphas + 1e-15], dim=-1)
    weights = alphas * torch.cumprod(shifted, dim=-1)[..., :-1]
    depth = torch.sum(weights * torch.cumsum(rs, dim=-1), dim=-1)
    return {"weights": weights,
            "weights_sum": torch.sum(weights, dim=-1),
            "depth": torch.clamp(depth - 0.0, min=0.0),
            "image": torch.sum(weights[..., None] * rgbs, dim=-2),
            "aggregated_density": torch.sum(weights * sigmas, dim=-1),
            "depth_abs": torch.sum(weights * ts * mask, dim=-1)}
