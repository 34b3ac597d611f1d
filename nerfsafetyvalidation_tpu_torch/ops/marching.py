"""Cascade-level helpers of the occupancy marcher
(nerfsafetyvalidation_tpu/ops/marching.py), used by the scout's mask."""

import torch


def _mip_from_pos(pos, cascade: int):
    """Smallest cascade whose [-2^l, 2^l] box contains pos."""
    mx = torch.amax(torch.abs(pos), dim=-1)
    lvl = torch.ceil(torch.log2(torch.clamp(mx, min=1e-8)))
    return torch.clamp(lvl, 0, cascade - 1).to(torch.int32)


def _mip_from_dt(dt, grid_size: int, cascade: int):
    """Cascade whose cell size (2 * 2^l / H) covers dt."""
    lvl = torch.ceil(torch.log2(torch.clamp(dt * grid_size / 2.0, min=1e-8)))
    return torch.clamp(lvl, 0, cascade - 1).to(torch.int32)
