"""Collision map -> signed distance field (nerfsafetyvalidation_tpu/
validation/utils/sdf.py), numpy and scipy: a density field voxelized on a
grid of `granularity` cells a metre, thresholded, and scipy's Euclidean
distance transform of the free cells in metres. The default extents are
the validation grid of the reference's Stonehenge scene."""

import numpy as np
import torch

GRANULARITY = 40
START = (-1.4, -1.3, -0.1)
END = (1.0, 1.0, 0.5)


def collision_map_from_density(density_fn, start=START, end=END,
                               granularity=GRANULARITY, thresh=10.0):
    """Occupancy (density > thresh) at the grid's points. density_fn: [N, 3]
    float32 numpy world points -> [N] densities (numpy, or a tensor on any
    device, e.g. the port's net on the card)."""
    axes = [np.arange(start[i], end[i], 1.0 / granularity) for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    sig = density_fn(pts)
    if isinstance(sig, torch.Tensor):
        sig = sig.detach().cpu().numpy()
    return np.asarray(sig).reshape(gx.shape) > thresh


def sdf_from_collision_map(collision_map, granularity=GRANULARITY):
    """Euclidean distance of each cell to the nearest occupied one, in
    metres."""
    import scipy.ndimage
    free = ~np.asarray(collision_map, dtype=bool)
    return scipy.ndimage.distance_transform_edt(free) / granularity


def build_sdf(density_fn=None, collision_map=None, out_path=None, **kw):
    if collision_map is None:
        collision_map = collision_map_from_density(density_fn, **kw)
    sdf = sdf_from_collision_map(collision_map,
                                 kw.get("granularity", GRANULARITY))
    if out_path is not None:
        np.save(out_path, sdf)
    return sdf
