"""The training dataset and its per-step ray batches
(nerfsafetyvalidation_tpu/data/provider.py: `NeRFDataset`,
`fast_collate_math`, `_Loader`).

`NeRFDataset` reads a split of a dataset directory, as the JAX package does
(provider.py:62-210): 'blender' mode (transforms_{train,val,test}.json,
'all' and 'trainval' merged) or 'colmap' mode (one transforms.json: the
first frame is the validation split, the rest the training split, and the
test split a camera path slerped between two frames drawn by numpy's global
generator); the PNGs through `data/png.py`, which needs neither cv2 nor PIL.
An image whose size differs from the split's H x W is resized as the JAX
package resizes it, with cv2's INTER_AREA on its uint8 pixels
(`data/resize.py`, the port's own copy of that rule). Or it reads a split of
the in-memory dataset that `data.synthetic.generate_dataset` returns (the
same values as the PNGs of its directory). Poses go through
`nerf_matrix_to_ngp`; the intrinsics come from fl_x / fl_y or camera_angle_x
/ camera_angle_y. With preload the images live on the device, in bfloat16
under fp16, as in the JAX package; otherwise on the host, and a batch's
images go to the device.

A training batch is one image: `num_rays` pixel indices drawn uniformly
(with repeats) from a torch.Generator, or handed in, as the tests hand in
JAX's draws; the epoch order is numpy's `default_rng(epoch)` shuffle, the
JAX package's own. With `--error_map` a training split keeps a map of
ERROR_MAP_RES^2 float32 ones a view (provider.py:183-187), its batches
draw their pixels by it (`rays.error_map_inds`) and carry 'index' and
'inds_coarse' for the trainer's update of the map.
"""

import glob
import json
import os

import numpy as np
import torch

from .png import read_png
from .rays import ERROR_MAP_RES, error_map_inds, nerf_matrix_to_ngp
from .resize import resize_area


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


def _read_transform(root, type):
    """(mode, the transform dict of split `type`) of a dataset directory
    (provider.py:72-105)."""
    if os.path.exists(os.path.join(root, "transforms.json")):
        with open(os.path.join(root, "transforms.json")) as f:
            return "colmap", json.load(f)
    if not os.path.exists(os.path.join(root, "transforms_train.json")):
        raise NotImplementedError(
            f"[NeRFDataset] Cannot find transforms*.json under {root}")
    if type == "all":
        names = glob.glob(os.path.join(root, "*.json"))
    elif type == "trainval":
        names = [os.path.join(root, f"transforms_{t}.json")
                 for t in ("train", "val")]
    else:
        names = [os.path.join(root, f"transforms_{type}.json")]
    transform = None
    for name in names:
        with open(name) as f:
            tmp = json.load(f)
        if transform is None:
            transform = tmp
        else:
            transform["frames"].extend(tmp["frames"])
    return "blender", transform


def _slerp_path(frames, scale, offset, n_test):
    """colmap mode's test split: n_test + 1 poses between two frames drawn
    by numpy's global generator, rotations slerped, positions blended
    (provider.py:166-182)."""
    from scipy.spatial.transform import Rotation, Slerp
    f0, f1 = np.random.choice(frames, 2, replace=False)
    pose0 = nerf_matrix_to_ngp(np.array(f0["transform_matrix"]), scale,
                               offset)
    pose1 = nerf_matrix_to_ngp(np.array(f1["transform_matrix"]), scale,
                               offset)
    slerp = Slerp([0, 1], Rotation.from_matrix(
        np.stack([pose0[:3, :3], pose1[:3, :3]])))
    poses = []
    for i in range(n_test + 1):
        ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = slerp(ratio).as_matrix()
        pose[:3, 3] = (1 - ratio) * pose0[:3, 3] + ratio * pose1[:3, 3]
        poses.append(pose)
    return poses


def _intrinsics(transform, H, W, downscale):
    """(fx, fy, cx, cy) (provider.py:259-274)."""
    if "fl_x" in transform or "fl_y" in transform:
        fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
        fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
    elif "camera_angle_x" in transform or "camera_angle_y" in transform:
        fl_x = W / (2 * np.tan(transform["camera_angle_x"] / 2)) \
            if "camera_angle_x" in transform else None
        fl_y = H / (2 * np.tan(transform["camera_angle_y"] / 2)) \
            if "camera_angle_y" in transform else None
        fl_x = fl_y if fl_x is None else fl_x
        fl_y = fl_x if fl_y is None else fl_y
    else:
        raise RuntimeError("Failed to load focal length, please check the "
                           "transforms.json!")
    cx = transform.get("cx", W / 2) / (downscale if "cx" in transform else 1)
    cy = transform.get("cy", H / 2) / (downscale if "cy" in transform else 1)
    return np.array([fl_x, fl_y, cx, cy])


class NeRFDataset:
    """opt needs: scale, offset, num_rays (training), preload, fp16, and
    path (the dataset directory) unless `splits` is given:
    `generate_dataset`'s return, in memory. `type` names the split
    ('train', 'val', 'test'; from a directory also 'all' and 'trainval');
    `downscale` divides the size a transform states."""

    def __init__(self, opt, splits=None, type: str = "train",
                 downscale: int = 1, device="cuda", n_test: int = 10):
        self.opt = opt
        self.type = type
        self.device = device
        self.training = type in ("train", "all", "trainval")
        self.num_rays = getattr(opt, "num_rays", 4096) if self.training \
            else -1
        if getattr(opt, "rand_pose", -1) >= 0:
            raise NotImplementedError("random-pose batches are not ported")
        self.error_map = None
        if splits is not None:
            split = splits[type]
            images = np.asarray(split["images"], dtype=np.float32)
            poses = [self._ngp(p) for p in split["poses"]]
            self.H, self.W = images.shape[1:3]
            transform = {"camera_angle_x": split["camera_angle_x"]}
            downscale = 1
        else:
            poses, images, transform = self._read(opt.path, type, downscale,
                                                  n_test)
        self.poses = np.stack(poses).astype(np.float32)
        if images is None:
            self.images = None
        elif getattr(opt, "preload", False):
            dtype = torch.bfloat16 if getattr(opt, "fp16", False) \
                else torch.float32
            self.images = torch.as_tensor(images).to(device=device,
                                                     dtype=dtype)
        else:
            self.images = torch.as_tensor(images)
        self.radius = float(np.linalg.norm(self.poses[:, :3, 3],
                                           axis=-1).mean())
        if self.training and getattr(opt, "error_map", False):
            self.error_map = np.ones((len(self.poses), ERROR_MAP_RES ** 2),
                                     dtype=np.float32)
        self.intrinsics = _intrinsics(transform, self.H, self.W, downscale)
        self._poses_dev = torch.as_tensor(self.poses, device=device)
        self._images_flat = None if self.images is None else \
            self.images.reshape(len(self.poses), -1, self.images.shape[-1])

    def _ngp(self, c2w):
        return nerf_matrix_to_ngp(np.asarray(c2w, dtype=np.float32),
                                  self.opt.scale, self.opt.offset)

    def _read(self, root, type, downscale, n_test):
        """(poses, images [N, H, W, C] float32 or None, transform) of a
        split of the directory `root`; sets H and W."""
        mode, transform = _read_transform(root, type)
        self.mode = mode
        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // downscale
            self.W = int(transform["w"]) // downscale
        else:
            self.H = self.W = None
        frames = transform["frames"]
        if mode == "colmap" and type == "test":
            return _slerp_path(frames, self.opt.scale, self.opt.offset,
                               n_test), None, transform
        if mode == "colmap":
            frames = frames[1:] if type == "train" else \
                frames[:1] if type == "val" else frames
        poses, images = [], []
        for f in frames:
            path = os.path.join(root, f["file_path"])
            if mode == "blender" and "." not in os.path.basename(path):
                path += ".png"
            if not os.path.exists(path):
                continue
            image = read_png(path)
            if self.H is None or self.W is None:
                self.H = image.shape[0] // downscale
                self.W = image.shape[1] // downscale
            if image.ndim != 3:
                raise ValueError(f"{path} is not an RGB or RGBA image")
            if image.shape[:2] != (self.H, self.W):
                if image.dtype != np.uint8:
                    raise NotImplementedError(
                        f"{path} is {image.dtype}; the port resizes uint8 "
                        "images only")
                image = resize_area(image, self.W, self.H)
            poses.append(self._ngp(f["transform_matrix"]))
            images.append(image.astype(np.float32) / 255.0)
        return poses, np.stack(images), transform

    @property
    def has_gt(self):
        return self.images is not None

    def collate(self, index, generator=None, inds=None):
        """The batch of images `index` (a list): rays and pixels at `inds`
        ([N] int64), or, for the training split, at N = min(num_rays, H *
        W) indices drawn from `generator` (by the error map where there is
        one, `rays.error_map_inds`); for another split, every pixel in raster
        order, with the images whole, [B, H, W, C], as the JAX package's
        collate gives them for evaluation. Returns {'H', 'W', 'rays_o',
        'rays_d', 'images' (where the split has them), 'inds'}, and with
        the error map 'index' and 'inds_coarse' [B, N]."""
        H, W = self.H, self.W
        dev = self._poses_dev.device
        whole = inds is None and not self.training
        coarse = None
        if whole:
            inds = torch.arange(H * W, device=dev)
        elif inds is None and self.error_map is not None:
            inds, coarse = error_map_inds(
                torch.as_tensor(self.error_map[np.asarray(index)],
                                device=dev), H, W,
                min(self.num_rays, H * W), generator=generator)
        elif inds is None:
            n = min(self.num_rays, H * W)
            inds = torch.randint(0, H * W, (n,), generator=generator,
                                 device=dev)
        B = len(index)
        idx = torch.as_tensor(np.asarray(index, dtype=np.int64))
        if self.images is None:
            flat = torch.zeros((B, H * W, 1), device=dev)
        else:
            # the batch's images only, moved to the device if they are not
            # there already
            flat = self._images_flat[idx.to(self._images_flat.device)].to(dev)
        rays_o, rays_d, inds, imgs = fast_collate_math(
            self._poses_dev[idx.to(dev)], flat, torch.arange(B, device=dev),
            torch.as_tensor(inds, device=dev),
            H=H, W=W, intrinsics=tuple(float(v) for v in self.intrinsics))
        out = {"H": H, "W": W, "rays_o": rays_o, "rays_d": rays_d,
               "inds": inds}
        if coarse is not None:
            out["index"] = list(index)
            out["inds_coarse"] = coarse
        if self.images is not None:
            out["images"] = imgs.reshape(B, H, W, -1) if whole else imgs
        return out

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
        self.has_gt = dataset.has_gt
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
