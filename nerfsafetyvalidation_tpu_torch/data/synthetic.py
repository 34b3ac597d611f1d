"""Analytic ground truth for the "spheres" scene, a numpy copy of the JAX
package's nerfsafetyvalidation_tpu/data/synthetic.py (`orbit_pose`,
`camera_rays`, `trace`, `scene_views`, `generate_dataset`); the "gauntlet"
tracer is not ported yet.

`generate_dataset` keeps its blender-format splits in memory: each image
holds the values a PNG round trip gives ((img * 255).clip(0, 255)
truncated to uint8, then / 255), and each pose the float32 matrix the JSON
would hold. `write_dataset` writes such splits as the JAX package's
`generate_dataset` writes its directory: transforms_{train,val,test}.json
and one RGBA PNG a view (data/png.py)."""

import json
import os

import numpy as np

from .png import write_png

SPHERES = [
    # (center, radius, albedo)
    ((0.00, 0.00, -0.10), 0.35, (0.85, 0.15, 0.15)),
    ((0.45, 0.30, 0.05), 0.20, (0.15, 0.25, 0.85)),
    ((-0.40, 0.35, -0.20), 0.25, (0.15, 0.75, 0.25)),
]
GROUND_Z = -0.5
LIGHT = np.asarray([0.4, 0.25, 0.88])
LIGHT_DIR = LIGHT / np.linalg.norm(LIGHT)


def camera_rays(pose, intrinsics, H, W):
    """OpenGL-convention pinhole rays. pose: [4,4] c2w; returns o,d [H,W,3]."""
    fx, fy, cx, cy = intrinsics
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dirs = np.stack([(j - cx) / fx, -(i - cy) / fy, -np.ones_like(i)],
                    axis=-1).astype(np.float64)
    d = dirs @ pose[:3, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(pose[:3, 3], d.shape)
    return o, d


def trace(o, d):
    """Closed-form trace. o,d: [..., 3]. Returns (rgb [..., 3], alpha, depth)."""
    shape = o.shape[:-1]
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n_rays = o.shape[0]
    best_t = np.full(n_rays, np.inf)
    rgb = np.zeros((n_rays, 3))
    hit = np.zeros(n_rays, dtype=bool)

    def shade(albedo, normal):
        lam = np.clip((normal * LIGHT_DIR).sum(-1), 0.0, 1.0)
        return np.asarray(albedo)[None] * (0.35 + 0.65 * lam)[:, None]

    for center, radius, albedo in SPHERES:
        oc = o - np.asarray(center)
        b = (oc * d).sum(-1)
        disc = b * b - (oc * oc).sum(-1) + radius * radius
        ok = disc > 0
        t = -b - np.sqrt(np.where(ok, disc, 0.0))
        ok &= (t > 1e-4) & (t < best_t)
        p = o + t[:, None] * d
        n = (p - np.asarray(center)) / radius
        col = shade(albedo, n)
        rgb[ok] = col[ok]
        best_t[ok] = t[ok]
        hit |= ok

    # ground plane z = GROUND_Z, checkerboard, only inside |x|,|y| < 1
    tz = (GROUND_Z - o[:, 2]) / np.where(np.abs(d[:, 2]) > 1e-9, d[:, 2], 1e-9)
    p = o + tz[:, None] * d
    okg = (tz > 1e-4) & (tz < best_t) & (np.abs(p[:, 0]) < 1.0) \
        & (np.abs(p[:, 1]) < 1.0)
    check = ((np.floor(p[:, 0] * 4) + np.floor(p[:, 1] * 4)) % 2).astype(bool)
    base = np.where(check[:, None], 0.82, 0.55)
    gcol = np.broadcast_to(base, (n_rays, 3)).copy()
    # sphere shadows on the ground (hard shadow toward the light)
    sh = np.zeros(n_rays, dtype=bool)
    for center, radius, _ in SPHERES:
        oc = p - np.asarray(center)
        b = (oc * LIGHT_DIR).sum(-1)
        disc = b * b - (oc * oc).sum(-1) + radius * radius
        sh |= (disc > 0) & (b < 0)
    gcol[sh] *= 0.55
    rgb[okg] = gcol[okg]
    best_t[okg] = tz[okg]
    hit |= okg

    alpha = hit.astype(np.float64)
    depth = np.where(hit, best_t, 0.0)
    return (rgb.reshape(shape + (3,)), alpha.reshape(shape),
            depth.reshape(shape))


TRACERS = {"spheres": trace}


def trace_scene(o, d, scene="spheres"):
    if scene not in TRACERS:
        raise NotImplementedError(f"scene {scene!r} is not ported")
    return TRACERS[scene](o, d)


def orbit_pose(theta, phi, radius):
    """c2w looking at the origin from spherical (theta azimuth, phi elev)."""
    pos = np.asarray([radius * np.cos(phi) * np.cos(theta),
                      radius * np.cos(phi) * np.sin(theta),
                      radius * np.sin(phi)])
    fwd = -pos / np.linalg.norm(pos)
    up = np.asarray([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up2
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = pos
    return c2w


def scene_views(n_views, H, W, radius=2.4, fov_x=0.6911, seed=0,
                phi_range=(0.2, 0.8), scene="spheres"):
    """Returns (images [N, H, W, 4] float32, poses [N, 4, 4], intrinsics)."""
    rng = np.random.default_rng(seed)
    fx = fy = 0.5 * W / np.tan(0.5 * fov_x)
    intr = (fx, fy, W / 2, H / 2)
    images, poses = [], []
    for k in range(n_views):
        theta = 2 * np.pi * (k / n_views) + rng.uniform(0, 0.3)
        phi = rng.uniform(*phi_range)
        pose = orbit_pose(theta, phi, radius)
        o, d = camera_rays(pose, intr, H, W)
        rgb, alpha, _ = trace_scene(o, d, scene)
        img = np.concatenate([rgb, alpha[..., None]], axis=-1)
        images.append(img.astype(np.float32))
        poses.append(pose.astype(np.float32))
    return np.stack(images), np.stack(poses), intr


FOV_X = 0.6911


def generate_dataset(n_train=48, n_val=4, n_test=8, H=200, W=200,
                     radius=2.4, seed=0, scene="spheres"):
    """The splits of a blender-format dataset, in memory: {'train' | 'val'
    | 'test': {'images' [N, H, W, 4] float32 (the PNG round trip's values),
    'poses' [N, 4, 4] float32 (raw c2w, as transforms_*.json holds them),
    'camera_angle_x'}}."""
    splits = {}
    for split, n, s in (("train", n_train, seed), ("val", n_val, seed + 1),
                        ("test", n_test, seed + 2)):
        images, poses, _ = scene_views(n, H, W, radius=radius, fov_x=FOV_X,
                                       seed=s, scene=scene)
        img8 = (images * 255).clip(0, 255).astype(np.uint8)
        splits[split] = {"images": img8.astype(np.float32) / 255.0,
                         "poses": poses, "camera_angle_x": FOV_X}
    return splits


def write_dataset(path, splits):
    """Write `generate_dataset`'s splits as a blender-format directory, in
    the JAX package's layout (synthetic.py:333-355): `{split}_{k:03d}.png`
    (RGBA, 8 bits) and transforms_{split}.json {'camera_angle_x', 'frames':
    [{'file_path': './{split}_{k:03d}', 'transform_matrix'}]}. Returns
    path."""
    os.makedirs(path, exist_ok=True)
    for split, data in splits.items():
        frames = []
        for k, (img, pose) in enumerate(zip(data["images"], data["poses"])):
            name = f"{split}_{k:03d}"
            # the stored values are uint8 / 255: back to the bytes exactly
            write_png(os.path.join(path, name + ".png"),
                      np.round(np.asarray(img) * 255.0).astype(np.uint8))
            frames.append({"file_path": f"./{name}",
                           "transform_matrix": np.asarray(
                               pose, dtype=np.float32).tolist()})
        with open(os.path.join(path, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": data["camera_angle_x"],
                       "frames": frames}, f)
    return path
