"""Analytic ground truth for the "spheres" and "gauntlet" scenes, a numpy
copy of the JAX package's nerfsafetyvalidation_tpu/data/synthetic.py
(`orbit_pose`, `camera_rays`, `trace`, `trace_gauntlet` with its helpers,
`trace_scene`, `scene_views`, `generate_dataset`), float64 as there.

"spheres": a checkered ground slab and three shaded spheres. "gauntlet":
the hard fidelity scene of bench.py's gate: a fence of thin vertical
cylinders, an occlusion stack of three offset slabs, a striped sphere and
fine checker and stripe textures.

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


# --------------------------------------------------------------- gauntlet
# thin structures + occlusion stack + high-frequency texture (see module
# docstring). All geometry fits in bound=1 and stands on the same ground
# plane as the sphere scene so the camera orbit is shared.

# vertical cylinders: (cx, cy, radius, z_top, albedo)
PILLARS = [
    (-0.55, -0.30, 0.020, 0.30, (0.90, 0.80, 0.20)),
    (-0.35, -0.42, 0.022, 0.38, (0.20, 0.80, 0.85)),
    (-0.12, -0.50, 0.018, 0.32, (0.85, 0.30, 0.75)),
    (0.12, -0.50, 0.022, 0.40, (0.95, 0.45, 0.15)),
    (0.35, -0.42, 0.018, 0.30, (0.35, 0.90, 0.30)),
    (0.55, -0.30, 0.020, 0.36, (0.25, 0.40, 0.95)),
    (0.00, -0.28, 0.025, 0.45, (0.95, 0.90, 0.85)),
]
PILLAR_Z0 = -0.5  # pillars stand on the ground plane

# occlusion stack: three thin vertical slabs (axis-aligned boxes), offset
# in x and stacked in y so every orbit view sees partial layered occlusion
# (xmin, xmax, ymin, ymax, zmin, zmax, albedo, stripe_axis)
SLABS = [
    (-0.50, 0.10, -0.02, 0.02, -0.50, 0.25, (0.85, 0.25, 0.20), 0),
    (-0.20, 0.40, 0.16, 0.20, -0.50, 0.35, (0.20, 0.55, 0.90), 2),
    (-0.35, 0.25, 0.34, 0.38, -0.50, 0.15, (0.30, 0.85, 0.35), 0),
]
STRIPE_FREQ = 26.0       # slab stripe spatial frequency (period ~0.12)
GAUNTLET_CHECK = 16.0    # ground checker frequency (4x the sphere scene's)

# striped sphere riding above the stack
GSPHERE = ((0.30, 0.42, 0.05), 0.16, (0.92, 0.88, 0.20), (0.25, 0.20, 0.60))


def _shade_lambert(albedo, normal):
    lam = np.clip((normal * LIGHT_DIR).sum(-1), 0.0, 1.0)
    return np.asarray(albedo)[None] * (0.35 + 0.65 * lam)[:, None]


def _ray_box(o, d, lo, hi):
    """Slab test. Returns (t_enter, hit_mask, normal[...,3])."""
    invd = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
    t0 = (lo[None] - o) * invd
    t1 = (hi[None] - o) * invd
    tmin_ax = np.minimum(t0, t1)
    tmax_ax = np.maximum(t0, t1)
    t_in = tmin_ax.max(-1)
    t_out = tmax_ax.min(-1)
    hit = (t_out > np.maximum(t_in, 1e-4))
    # entry-face normal: the axis achieving t_in, signed against d
    ax = np.argmax(tmin_ax, axis=-1)
    n = np.zeros_like(o)
    rows = np.arange(o.shape[0])
    n[rows, ax] = -np.sign(d[rows, ax])
    return t_in, hit, n


def _ray_cyl_z(o, d, cx, cy, r, z0, z1):
    """Finite vertical cylinder (side wall + top cap).
    Returns (t, hit_mask, normal)."""
    ox = o[:, 0] - cx
    oy = o[:, 1] - cy
    a = d[:, 0] ** 2 + d[:, 1] ** 2
    b = ox * d[:, 0] + oy * d[:, 1]
    c = ox ** 2 + oy ** 2 - r * r
    disc = b * b - a * c
    ok = (disc > 0) & (a > 1e-12)
    sq = np.sqrt(np.where(ok, disc, 0.0))
    t = (-b - sq) / np.where(a > 1e-12, a, 1.0)
    z = o[:, 2] + t * d[:, 2]
    side = ok & (t > 1e-4) & (z > z0) & (z < z1)
    n_side = np.zeros_like(o)
    n_side[:, 0] = (ox + t * d[:, 0]) / r
    n_side[:, 1] = (oy + t * d[:, 1]) / r
    # top cap (disk at z1)
    tz = (z1 - o[:, 2]) / np.where(np.abs(d[:, 2]) > 1e-12, d[:, 2], 1e-12)
    px = o[:, 0] + tz * d[:, 0] - cx
    py = o[:, 1] + tz * d[:, 1] - cy
    cap = (tz > 1e-4) & (px ** 2 + py ** 2 < r * r)
    n_cap = np.zeros_like(o)
    n_cap[:, 2] = 1.0
    use_cap = cap & (~side | (tz < t))
    t_out = np.where(use_cap, tz, t)
    hit = side | use_cap
    n = np.where(use_cap[:, None], n_cap, n_side)
    return t_out, hit, n


def trace_gauntlet(o, d):
    """Closed-form trace of the hard scene. Same contract as trace()."""
    shape = o.shape[:-1]
    o = o.reshape(-1, 3).astype(np.float64)
    d = d.reshape(-1, 3).astype(np.float64)
    n_rays = o.shape[0]
    best_t = np.full(n_rays, np.inf)
    rgb = np.zeros((n_rays, 3))
    hit = np.zeros(n_rays, dtype=bool)

    def accept(ok, t, col):
        nonlocal best_t, rgb, hit
        ok = ok & (t > 1e-4) & (t < best_t)
        rgb[ok] = col[ok]
        best_t[ok] = t[ok]
        hit |= ok

    # pillars (thin cylinders)
    for cx, cy, r, z1, albedo in PILLARS:
        t, okc, n = _ray_cyl_z(o, d, cx, cy, r, PILLAR_Z0, z1)
        accept(okc, t, _shade_lambert(albedo, n))

    # occlusion-stack slabs with high-frequency stripes
    for xmin, xmax, ymin, ymax, zmin, zmax, albedo, sax in SLABS:
        lo = np.asarray([xmin, ymin, zmin])
        hi = np.asarray([xmax, ymax, zmax])
        t, okb, n = _ray_box(o, d, lo, hi)
        p = o + t[:, None] * d
        stripe = (np.floor(p[:, sax] * STRIPE_FREQ) % 2).astype(bool)
        col = _shade_lambert(albedo, n)
        col = np.where(stripe[:, None], col, col * 0.35)
        accept(okb, t, col)

    # striped sphere
    center, radius, alb_a, alb_b = GSPHERE
    oc = o - np.asarray(center)
    b = (oc * d).sum(-1)
    disc = b * b - (oc * oc).sum(-1) + radius * radius
    oks = disc > 0
    t = -b - np.sqrt(np.where(oks, disc, 0.0))
    p = o + t[:, None] * d
    n = (p - np.asarray(center)) / radius
    phi_band = (np.floor(np.arctan2(n[:, 1], n[:, 0]) * 8 / np.pi) % 2) \
        .astype(bool)
    col = np.where(phi_band[:, None], _shade_lambert(alb_a, n),
                   _shade_lambert(alb_b, n))
    accept(oks, t, col)

    # fine-checker ground with hard shadows from every occluder
    tz = (GROUND_Z - o[:, 2]) / np.where(np.abs(d[:, 2]) > 1e-9,
                                         d[:, 2], 1e-9)
    p = o + tz[:, None] * d
    okg = (tz > 1e-4) & (tz < best_t) & (np.abs(p[:, 0]) < 1.0) \
        & (np.abs(p[:, 1]) < 1.0)
    check = ((np.floor(p[:, 0] * GAUNTLET_CHECK)
              + np.floor(p[:, 1] * GAUNTLET_CHECK)) % 2).astype(bool)
    base = np.where(check[:, None], 0.85, 0.45)
    gcol = np.broadcast_to(base, (n_rays, 3)).copy()
    sh = np.zeros(n_rays, dtype=bool)
    ld = LIGHT_DIR
    for cx, cy, r, z1, _ in PILLARS:          # pillar shadows
        ox = p[:, 0] - cx
        oy = p[:, 1] - cy
        a = ld[0] ** 2 + ld[1] ** 2
        bq = ox * ld[0] + oy * ld[1]
        cq = ox ** 2 + oy ** 2 - r * r
        disc = bq * bq - a * cq
        okq = disc > 0
        s = (-bq + np.sqrt(np.where(okq, disc, 0.0))) / a
        z = p[:, 2] + s * ld[2]
        sh |= okq & (s > 1e-4) & (z > PILLAR_Z0) & (z < z1)
    for xmin, xmax, ymin, ymax, zmin, zmax, _, _ in SLABS:   # slab shadows
        lo = np.asarray([xmin, ymin, zmin])
        hi = np.asarray([xmax, ymax, zmax])
        t_in, okb, _ = _ray_box(p, np.broadcast_to(ld, p.shape), lo, hi)
        sh |= okb & (t_in > 1e-4)
    oc = p - np.asarray(GSPHERE[0])            # sphere shadow
    bq = (oc * ld).sum(-1)
    disc = bq * bq - (oc * oc).sum(-1) + GSPHERE[1] ** 2
    sh |= (disc > 0) & (bq < 0)
    gcol[sh] *= 0.55
    rgb[okg] = gcol[okg]
    best_t[okg] = tz[okg]
    hit |= okg

    alpha = hit.astype(np.float64)
    depth = np.where(hit, best_t, 0.0)
    return (rgb.reshape(shape + (3,)), alpha.reshape(shape),
            depth.reshape(shape))


TRACERS = {"spheres": trace, "gauntlet": trace_gauntlet}


def trace_scene(o, d, scene="spheres"):
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


def write_dataset(path, splits, split_dirs: bool = False):
    """Write `generate_dataset`'s splits as a blender-format directory, in
    the JAX package's layout (synthetic.py:333-355): `{split}_{k:03d}.png`
    (RGBA, 8 bits) and transforms_{split}.json {'camera_angle_x', 'frames':
    [{'file_path': './{split}_{k:03d}', 'transform_matrix'}]}. With
    `split_dirs` each split's images go to the directory {split}/ (the
    NeRF-synthetic layout, './{split}/{split}_{k:03d}', which the
    `uncertain` entry lists). Returns path."""
    os.makedirs(path, exist_ok=True)
    for split, data in splits.items():
        frames = []
        if split_dirs:
            os.makedirs(os.path.join(path, split), exist_ok=True)
        for k, (img, pose) in enumerate(zip(data["images"], data["poses"])):
            name = f"{split}_{k:03d}"
            if split_dirs:
                name = f"{split}/{name}"
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
