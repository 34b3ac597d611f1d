"""Pinhole rays, pose convention and colour space
(nerfsafetyvalidation_tpu/data/rays.py: `get_rays`, `rays_for_pixels`,
`nerf_matrix_to_ngp`, `srgb_to_linear`, `linear_to_srgb`). The JAX
`get_rays`' subsampling branches are the port's `NeRFDataset.collate`: its
uniform draw there, its error-map draw through `error_map_inds`."""

import numpy as np
import torch

# the error map's side: a view's map is ERROR_MAP_RES^2 coarse cells
ERROR_MAP_RES = 128


def linear_to_srgb(x):
    return torch.where(x < 0.0031308, 12.92 * x,
                       1.055 * x ** 0.41666 - 0.055)


def srgb_to_linear(x):
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def nerf_matrix_to_ngp(pose, scale=0.33, offset=(0, 0, 0)):
    """[4, 4] nerf-convention c2w -> ngp convention (numpy float32)."""
    pose = np.asarray(pose, dtype=np.float32)
    return np.array([
        [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
        [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
        [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
        [0, 0, 0, 1],
    ], dtype=np.float32)


def error_map_inds(error_map, H: int, W: int, N: int, generator=None,
                   draws=None):
    """Pixel indices drawn by the error map (rays.py:63-79): per view, N
    coarse cells of the ERROR_MAP_RES^2 map, drawn with probabilities
    proportional to max(map, 1e-12) (the JAX package's categorical over
    log(clip(map, 1e-12))), then a pixel uniformly inside each cell:
    floor(cell_x * sx + u * sx), clipped, with sx = H / ERROR_MAP_RES (y
    and W alike). error_map [B, ERROR_MAP_RES^2]. The draws come from
    `generator` on the map's device, or from `draws` {'inds_coarse' [B, N]
    int, 'u_x', 'u_y' [B, N] uniforms}, as the tests hand in JAX's.
    Returns (inds [B, N], inds_coarse [B, N]), int64."""
    error_map = torch.as_tensor(error_map, dtype=torch.float32)
    dev = error_map.device
    B = error_map.shape[0]
    if draws is None:
        probs = torch.clamp(error_map, min=1e-12)
        coarse = torch.multinomial(probs, N, replacement=True,
                                   generator=generator)
        u_x = torch.rand((B, N), generator=generator, device=dev)
        u_y = torch.rand((B, N), generator=generator, device=dev)
    else:
        coarse = torch.as_tensor(np.array(draws["inds_coarse"]),
                                 dtype=torch.int64, device=dev)
        u_x = torch.as_tensor(np.array(draws["u_x"]), device=dev)
        u_y = torch.as_tensor(np.array(draws["u_y"]), device=dev)
    res = ERROR_MAP_RES
    sx, sy = H / res, W / res
    ix = torch.clamp((torch.div(coarse, res, rounding_mode="floor").float()
                      * sx + u_x * sx).to(torch.int32), 0, H - 1)
    iy = torch.clamp(((coarse % res).float() * sy + u_y * sy)
                     .to(torch.int32), 0, W - 1)
    return (ix * W + iy).to(torch.int64), coarse


def get_rays(poses, intrinsics, H: int, W: int, device="cuda"):
    """poses: [B, 4, 4] c2w (numpy, or a tensor); intrinsics: (fx, fy, cx,
    cy). Returns {'rays_o', 'rays_d'}: [B, H*W, 3] float32 on `device`,
    pixel centres at +0.5, unit directions."""
    if not isinstance(poses, torch.Tensor):
        poses = np.asarray(poses)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
    B = poses.shape[0]
    fx, fy, cx, cy = [float(v) for v in np.asarray(intrinsics).reshape(-1)[:4]]
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    i = i.reshape(H * W) + 0.5
    j = j.reshape(H * W) + 0.5
    directions = torch.stack([(i - cx) / fx, (j - cy) / fy,
                              torch.ones_like(i)], dim=-1)
    directions = directions / torch.linalg.norm(directions, dim=-1,
                                                keepdim=True)
    rays_d = torch.einsum("nk,bjk->bnj", directions, poses[:, :3, :3])
    rays_o = poses[:, None, :3, 3].expand(rays_d.shape)
    return {"rays_o": rays_o, "rays_d": rays_d}


def rays_for_pixels(pose, intrinsics, coords):
    """The rays of the pixels coords [B, 2] (row, col, integers) of the
    camera pose [4, 4] c2w (a tensor; differentiable in it): equal, bit
    for bit, to `get_rays(pose[None], intrinsics, H, W)` indexed at those
    pixels (the same pixel centres, normalisation and rotation). Returns
    (rays_o [B, 3], rays_d [B, 3]) on the pose's device."""
    pose = pose.to(torch.float32)
    fx, fy, cx, cy = [float(v) for v in np.asarray(intrinsics).reshape(-1)[:4]]
    i = coords[:, 1].to(device=pose.device, dtype=torch.float32) + 0.5
    j = coords[:, 0].to(device=pose.device, dtype=torch.float32) + 0.5
    directions = torch.stack([(i - cx) / fx, (j - cy) / fy,
                              torch.ones_like(i)], dim=-1)
    directions = directions / torch.linalg.norm(directions, dim=-1,
                                                keepdim=True)
    rays_d = torch.einsum("nk,jk->nj", directions, pose[:3, :3])
    return pose[:3, 3].expand(rays_d.shape), rays_d
