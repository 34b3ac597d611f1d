"""Slab test and morton codes (nerfsafetyvalidation_tpu/ops/ray_ops.py).

Morton codes are computed in int64: every mask keeps only the low 32 bits,
so the result equals the JAX package's uint32 arithmetic."""

import torch

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
