"""Slab test, the background sphere's coordinates, morton codes and the
occupancy bitfield (nerfsafetyvalidation_tpu/ops/ray_ops.py).

Morton codes are computed in int64: every mask keeps only the low 32 bits,
so the result equals the JAX package's uint32 arithmetic."""

import math

import torch
import torch.nn.functional as F

_F32_MAX = torch.finfo(torch.float32).max


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.2):
    """rays_o/d: [..., 3]; aabb: [6] (min xyz, max xyz). Returns
    (nears, fars); both are float32 max where the ray misses the box."""
    rd = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * rd
    t1 = (aabb[3:] - rays_o) * rd
    near = torch.amax(torch.minimum(t0, t1), dim=-1)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    near = torch.where(miss, _F32_MAX, near)
    far = torch.where(miss, _F32_MAX, far)
    return near, far


def sph_from_ray(rays_o, rays_d, radius: float):
    """Where rays [..., 3] leave the background sphere of `radius`, as
    (theta, phi) scaled to [-1, 1] [..., 2] (raymarching.cu:164-200; y is
    up), in float32."""
    A = torch.sum(rays_d * rays_d, dim=-1)
    B = torch.sum(rays_o * rays_d, dim=-1)
    C = torch.sum(rays_o * rays_o, dim=-1) - radius * radius
    t = (-B + torch.sqrt(B * B - A * C)) / A
    p = rays_o + t[..., None] * rays_d
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)      # [0, pi)
    phi = torch.atan2(z, x)                                 # [-pi, pi)
    return torch.stack([2.0 * theta / math.pi - 1.0, phi / math.pi], dim=-1)


def _expand_bits(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """coords: [..., 3] ints in [0, 1024) -> morton codes [...] int32."""
    c = coords.to(torch.int64)
    code = (_expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1)
            | (_expand_bits(c[..., 2]) << 2))
    return code.to(torch.int32)


def _compact_bits(v):
    v = v & 0x49249249
    v = (v | (v >> 2)) & 0xC30C30C3
    v = (v | (v >> 4)) & 0x0F00F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """codes: [...] -> [..., 3] int32 coords."""
    m = codes.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([_compact_bits(m), _compact_bits(m >> 1),
                        _compact_bits(m >> 2)], dim=-1).to(torch.int32)


def packbits(grid, thresh):
    """Density grid [CAS, H^3] -> occupancy bitfield [CAS * H^3 // 8]
    uint8; bit i of byte n is cell 8n + i (raymarching.cu:269-301)."""
    occ = (grid.reshape(-1) > thresh).to(torch.int32).reshape(-1, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=grid.device)
    return (occ << shifts).sum(dim=-1).to(torch.uint8)


def occupancy_to_skip_grid(occ, grid_size: int, max_skip: int = 15):
    """Chebyshev distance to the nearest occupied cell, capped at max_skip.

    occ: [CAS, H^3] bool in morton order. Returns uint8 [CAS, H^3] in
    morton order: 0 where occupied; d > 0 lets a ray jump (d - 1) cell
    widths. Computed by max_skip rounds of 3x3x3 min-pooling in xyz
    layout; `-max_pool3d(-d)` pads with +inf as the JAX package's
    reduce_window(min, init=inf) does."""
    H = grid_size
    cas = occ.shape[0]
    g = torch.arange(H, dtype=torch.int32, device=occ.device)
    coords = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                         dim=-1).reshape(-1, 3)
    morton = morton3d(coords).to(torch.int64)     # xyz row -> morton index
    occ_xyz = occ[:, morton]
    d = torch.where(occ_xyz, 0.0, float(max_skip)).reshape(cas, 1, H, H, H)
    for _ in range(max_skip):
        m = -F.max_pool3d(-d, 3, stride=1, padding=1)
        d = torch.minimum(d, m + 1.0)
    skip = torch.empty((cas, H ** 3), dtype=torch.float32, device=occ.device)
    skip[:, morton] = d.reshape(cas, H ** 3)
    return torch.clamp(skip, 0, max_skip).to(torch.uint8)


def bitfield_lookup(bitfield, idx):
    """Occupancy bit `idx` (int tensor) of a packed bitfield, as bool."""
    byte = bitfield[idx >> 3].to(torch.int64)
    return ((byte >> (idx & 7)) & 1).to(torch.bool)
