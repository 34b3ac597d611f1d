"""The training dataset and its per-step ray batches
(nerfsafetyvalidation_tpu/data/provider.py: `NeRFDataset` in blender mode,
`fast_collate_math`, `_Loader`).

`NeRFDataset` reads a split of the in-memory dataset that
`data.synthetic.generate_dataset` returns (the JAX package reads the same
values from PNGs and transforms_*.json; reading a blender directory is not
ported). Poses go through `nerf_matrix_to_ngp`; the intrinsics come from
camera_angle_x. With preload the images live on the device, in bfloat16
under fp16, as in the JAX package.

A training batch is one image: `num_rays` pixel indices drawn uniformly
(with repeats) from a torch.Generator, or handed in, as the tests hand in
JAX's draws; the epoch order is numpy's `default_rng(epoch)` shuffle, the
JAX package's own.
"""

import numpy as np
import torch

from .rays import nerf_matrix_to_ngp


def fast_collate_math(poses_all, images_flat, idx, inds, *, H: int, W: int,
                      intrinsics):
    """Rays and pixels of images idx [B] at pixel indices inds [N] (int64,
    the same pixels in every image). poses_all [V, 4, 4], images_flat
    [V, H * W, C]. Returns (rays_o [B, N, 3], rays_d [B, N, 3], inds
    [B, N], images [B, N, C] float32)."""
    fx, fy, cx, cy = intrinsics
    poses = poses_all[idx]                                    # [B, 4, 4]
    inds = inds.expand(idx.shape[0], inds.shape[-1])
    # meshgrid(indexing="xy") raveled row-major: n -> (n // W, n % W)
    i = (inds % W).float() + 0.5
    j = (inds // W).float() + 0.5
    zs = torch.ones_like(i)
    dirs = torch.stack([(i - cx) / fx * zs, (j - cy) / fy * zs, zs], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = torch.einsum("bnk,bjk->bnj", dirs, poses[:, :3, :3])
    rays_o = poses[:, None, :3, 3].expand(rays_d.shape)
    imgs = torch.gather(images_flat[idx], 1,
                        inds[..., None].expand(-1, -1,
                                               images_flat.shape[-1]))
    return rays_o, rays_d, inds, imgs.float()


class NeRFDataset:
    """opt needs: scale, offset, num_rays (training), preload, fp16.
    `splits` is `generate_dataset`'s return; `type` names the split
    ('train' or 'val')."""

    def __init__(self, opt, splits, type: str = "train", device="cuda"):
        self.opt = opt
        self.type = type
        self.device = device
        self.training = type == "train"
        self.num_rays = getattr(opt, "num_rays", 4096) if self.training \
            else -1
        split = splits[type]
        images = np.asarray(split["images"], dtype=np.float32)
        self.H, self.W = images.shape[1:3]
        self.poses = np.stack([
            nerf_matrix_to_ngp(np.asarray(p, dtype=np.float32), opt.scale,
                               opt.offset) for p in split["poses"]
        ]).astype(np.float32)
        if getattr(opt, "preload", False):
            dtype = torch.bfloat16 if getattr(opt, "fp16", False) \
                else torch.float32
            self.images = torch.as_tensor(images).to(device=device,
                                                     dtype=dtype)
        else:
            self.images = torch.as_tensor(images)
        self.radius = float(np.linalg.norm(self.poses[:, :3, 3],
                                           axis=-1).mean())
        self.error_map = None
        fl = self.W / (2 * np.tan(split["camera_angle_x"] / 2))
        self.intrinsics = np.array([fl, fl, self.W / 2, self.H / 2])
        self._poses_dev = torch.as_tensor(self.poses, device=device)
        self._images_flat = self.images.reshape(len(self.poses), -1,
                                                self.images.shape[-1])

    def collate(self, index, generator=None, inds=None):
        """The batch of images `index` (a list): rays and pixels at `inds`
        ([N] int64), or, for the training split, at N = min(num_rays, H *
        W) indices drawn from `generator`; for another split, every pixel
        in raster order, with the images whole, [B, H, W, C], as the JAX
        package's collate gives them for evaluation. Returns {'H', 'W',
        'rays_o', 'rays_d', 'images', 'inds'}."""
        H, W = self.H, self.W
        dev = self._poses_dev.device
        whole = inds is None and not self.training
        if whole:
            inds = torch.arange(H * W, device=dev)
        elif inds is None:
            n = min(self.num_rays, H * W)
            inds = torch.randint(0, H * W, (n,), generator=generator,
                                 device=dev)
        idx = torch.as_tensor(np.asarray(index, dtype=np.int64), device=dev)
        rays_o, rays_d, inds, imgs = fast_collate_math(
            self._poses_dev, self._images_flat.to(dev), idx,
            torch.as_tensor(inds, device=dev),
            H=H, W=W, intrinsics=tuple(float(v) for v in self.intrinsics))
        if whole:
            imgs = imgs.reshape(len(index), H, W, -1)
        return {"H": H, "W": W, "rays_o": rays_o, "rays_d": rays_d,
                "images": imgs, "inds": inds}

    def dataloader(self, generator=None):
        """Per-image batches; a training loader reshuffles every epoch."""
        return _Loader(self, generator)

    def __len__(self):
        return len(self.poses)


class _Loader:
    def __init__(self, dataset: NeRFDataset, generator=None):
        self._data = dataset
        self.size = len(dataset)
        self.generator = generator if generator is not None else \
            torch.Generator(device=dataset._poses_dev.device).manual_seed(0)
        self.epoch = 0

    def __len__(self):
        return self.size

    def iter_indices(self):
        """One epoch's image order, advancing the epoch as __iter__ does:
        numpy's default_rng(epoch) shuffle when training."""
        self.epoch += 1
        order = np.arange(self.size)
        if self._data.training:
            np.random.default_rng(self.epoch).shuffle(order)
        return [int(i) for i in order]

    def __iter__(self):
        for idx in self.iter_indices():
            yield self._data.collate([idx], self.generator)
