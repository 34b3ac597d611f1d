"""bench.py's configurations in the port, for each of its two scenes
("spheres", "gauntlet"; `scene_assets`, bench.py:72-82): the trained
mip-fold teacher of `bench_assets/flagship{,_gauntlet}.ckpt` with its
occupancy refreshed 4x, the committed 6-layer students of width 160, 192
and 256, the four held-out poses at 800x800, and the frame settings of the
modes `fast`, `guided`, `baked_h160_ak8`, `baked_h160`, `baked_h192` and
`baked` (bench.py:177-181, :233-241, :431, :574-660); and bench.py's
reference-backbone line: the trained hash-grid `NeRFNetwork` of
`bench_assets/refbb{,_gauntlet}.ckpt` with its own occupancy refreshed 4x,
rendered
with all 16 levels (`ref_backbone`) and with the levels below 8 only
(`ref_backbone_ml8`) (bench.py:354-425, :805-845); and the same net as the
reference's entry points observe a trained NeRF: the staged render at the
CLI's defaults, on a fused `NeRFNetwork` built directly (`staged`: float32,
K4's f32 kernel; `staged_bf16`: bfloat16, K4's bf16 kernel). No JAX command
line builds either net: `-O` without `--ff` runs the unfused chain, and
`--ff` builds `NeRFNetworkFF`, a bf16 net of another topology.

Training: `TRAIN_CFG` and `TRAIN_OPT` are bench.py's `_train_flagship`
(bench.py:153-256) with `train_gather="foldrow_pallas"`, the route of
kernel K5; `train_flagship` runs that schedule on the spheres set from a
seeded init and refreshes the trained occupancy 4x. `REF_TRAIN_CFG` and
`REF_TRAIN_OPT` are bench.py's `_train_ref_backbone` (bench.py:354-426),
the schedule `refbb.ckpt` was trained with; `train_ref` runs it, through
kernel K4 (`fused`) or the plain chain (bench.py's own route), and
refreshes the occupancy 4x with seeds 100-103. `train_flagship` also takes
config overrides: with `fused=True` the teacher trains through kernel K3
forward and backward (JAX's NetworkConfig(encoding="mipfold", fused=True)
computes in float32 by default), and the options' `fold_warmup_scale`
folds the warm-up steps at a reduced scale.

Float32: `load_teacher_net`, `load_student_net` and `student_cfg` take a
`compute_dtype`. The committed teacher and students in "float32" run K3's
and K1's float32 kernels; bench.py serves both in bfloat16.

Distillation: `STUDENT_SCHEDULES` and `student_schedule` are bench.py's
per-width (distill, fine-tune) step counts (bench.py:253-264),
`ray_pool` the fine-tune's ray pool and `distill_student` the body of
bench.py's `_get_student` (:267-351) without its cache: the student of a
width distilled from a served teacher, then fine-tuned in pixel space.
`assets.save_student` writes the pkl that bench.py caches."""

import json
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .assets import load_checkpoint, load_student, params_from_jax
from .config import NetworkConfig
from .data.provider import NeRFDataset
from .data.rays import get_rays, nerf_matrix_to_ngp
from .data.synthetic import generate_dataset, orbit_pose
from .models import make_network
from .models.bake import distill, finetune_render, student_config
from .models.renderer import render as render_staged
from .models.renderer import (render_frame_fast, render_frame_guided,
                              update_extra_state)
from .train.trainer import Trainer
from .validation.batched import (FullBatchedRolloutEngine,
                                 start_state_from_pose)

ROOT = Path(__file__).resolve().parents[1]
ASSETS = ROOT / "bench_assets"
SCENES = ("spheres", "gauntlet")
# the students' hidden widths (6 layers each) and their asset names'
# suffixes (bench.py `_get_student`: the 256-wide one is the base name)
STUDENT_WIDTHS = {160: "_h160x6", 192: "_h192x6", 256: ""}


def scene_assets(scene: str = "spheres"):
    """The committed assets of a bench scene: {'teacher', 'ref': the
    checkpoints, 'students': {hidden width: the student pkl}}."""
    if scene not in SCENES:
        raise ValueError(f"bench scenes are {SCENES}, not {scene!r}")
    tag = "" if scene == "spheres" else f"_{scene}"
    return {"teacher": ASSETS / f"flagship{tag}.ckpt",
            "ref": ASSETS / f"refbb{tag}.ckpt",
            "students": {h: ASSETS / f"bench_student{tag}{s}.pkl"
                         for h, s in STUDENT_WIDTHS.items()}}


CKPT = scene_assets()["teacher"]
REF_CKPT = scene_assets()["ref"]

RES = 800
FOV_X = 0.6911
HOLDOUT = [(0.77, 0.52), (2.31, 0.30), (3.85, 0.65), (5.40, 0.42)]
REFRESHES = 4
DT_GAMMA = 1.0 / 64
REF_MAX_LEVEL = 8           # bench.py's BENCH_REF_MAX_LEVEL default

TEACHER_CFG = NetworkConfig(
    encoding="mipfold", bound=1.0, compute_dtype="bfloat16", num_levels=8,
    level_dim=4, base_resolution=16, fold_max_scale=128,
    log2_hashmap_size=19, density_thresh=10.0, grid_size=128, fused=True)


def student_cfg(hidden: int = 160, compute_dtype: str = "bfloat16"):
    """The 6-layer student of width `hidden`, through K1."""
    return replace(student_config(
        NetworkConfig(bound=1.0, compute_dtype=compute_dtype, grid_size=128),
        multires=12, hidden_dim=hidden, num_layers=6), fused=True)


# bench.py:371-373 (16 levels x 2 channels from 16, 2^19 rows, desired
# resolution 2048); both MLPs through K4
REF_CFG = NetworkConfig(encoding="hashgrid", bound=1.0,
                        compute_dtype="bfloat16", density_thresh=10.0,
                        fused=True)
# the config `network_config_from_opt` gives for --ff without --fp16
# (config.py:184-185), built directly as a fused float32 `NeRFNetwork`
# (--ff itself builds `NeRFNetworkFF`, bf16): the only net that launches
# K4's f32 kernel
REF_CFG_F32 = replace(REF_CFG, compute_dtype="float32")

# bench.py:177-215: the teacher trained at the served width, through K5
TRAIN_CFG = replace(TEACHER_CFG, fused=False, grid_ray=True,
                    train_gather="foldrow_pallas")
TRAIN_ITERS = 1920          # BENCH_ITERS
TRAIN_RES = 200             # BENCH_TRAIN_RES
N_TRAIN_VIEWS = 48
TRAIN_OPT = dict(
    color_space="srgb", scale=1.0, offset=(0.0, 0.0, 0.0), bound=1.0,
    fp16=True, preload=True, num_rays=4096, lr=1e-2, iters=TRAIN_ITERS,
    update_extra_interval=16, grid_partial_blocks=4,
    grid_max_samples=96, grid_samples_per_hit=2,
    grid_sample_budget_per_ray=48, grid_warmup_steps=512,
    grid_budget_after_warmup=16, grid_max_samples_after_warmup=32,
    max_steps=1024, dt_gamma=DT_GAMMA, seed=0,
    # the trainer's evaluation: the staged render, 128 uniform steps, no
    # upsampling (bench.py:201-203)
    num_steps=128, upsample_steps=0, max_ray_batch=4096)

# bench.py:354-426: the hash-grid reference backbone trained through the
# march in bf16, 960 steps of 4096 rays on the same 48 views
REF_TRAIN_CFG = replace(REF_CFG, fused=False, grid_ray=True)
REF_TRAIN_ITERS = 960       # min(BENCH_ITERS, 960)
REF_TRAIN_OPT = dict(
    TRAIN_OPT, iters=REF_TRAIN_ITERS, grid_max_samples=48,
    grid_samples_per_hit=2, grid_sample_budget_per_ray=24,
    grid_warmup_steps=128, grid_budget_after_warmup=16,
    grid_max_samples_after_warmup=32)
# the port's ref_backbone PSNR on pose 0 of the committed refbb.ckpt, which
# holds that schedule's result (chip runs, PERF.md section 6), and the
# band a port-trained net of the same schedule must lie in, on the mean
# over seeds
REF_CKPT_DB = 27.018
REF_BAND_DB = 0.5

_FAST = dict(tile=131072, max_samples=16, max_steps=512, dt_gamma=DT_GAMMA,
             bg_color=1.0)
# the observation render of the reference's entry points at the CLI's
# defaults (cli.py:36-42; validate.py:419-425): staged over chunks of 4,096
# rays, 512 uniform samples, no upsampling, white background, no jitter
STAGED = dict(staged=True, max_ray_batch=4096, num_steps=512,
              upsample_steps=0, bg_color=1.0, perturb=False)



def _baked(hidden, **extra):
    """bench.py's `mode_baked_k(16, hidden_dim=hidden, num_layers=6)`
    (:574-593): the scout frame over the student of width `hidden`."""
    return dict(net=f"student_h{hidden}", kernel="K1", frame=dict(
        prepass_factor=8, prepass_mode="scout", scout_samples=64,
        max_samples=16, tile=8192, max_steps=512, dt_gamma=DT_GAMMA,
        bg_color=1.0, margin_cells=6.0, **extra))


# frame settings of each mode; the net each mode shades, and its kernel
MODES = {
    "fast": dict(net="teacher", kernel="K3", frame=_FAST),
    "guided": dict(net="teacher", kernel="K3", frame=dict(
        prepass_factor=8, max_samples=16, tile=16384, max_steps=512,
        dt_gamma=DT_GAMMA, prepass_mode="march", bg_color=1.0,
        margin_cells=6.0)),
    "baked_h160_ak8": _baked(160, adaptive_k=8, adaptive_span_cells=24.0),
    "baked_h160": _baked(160),
    "baked_h192": _baked(192),
    "baked": _baked(256),
    "ref_backbone": dict(net="ref", kernel="K4", frame=_FAST),
    "ref_backbone_ml8": dict(net="ref_ml8", kernel="K4", frame=_FAST),
    "staged": dict(net="ref_f32", kernel="K4 f32", frame=STAGED),
    "staged_bf16": dict(net="ref", kernel="K4", frame=STAGED),
}
MARCHED = ("fast", "ref_backbone", "ref_backbone_ml8")
STAGED_MODES = ("staged", "staged_bf16")


# the batched rollout engines on the spheres assets: validate.py's
# --batched_rollouts observation side (cli.py:95), 16 sims, each path's net
# (the student over the teacher's occupancy, the teacher, the ref net
# without occupancy), envConfig.json's dynamics and disturbances, hover
# actions, the start whose observation camera is held-out pose 0
ROLLOUT_OBS = 100
ROLLOUT_SIMS = 16
ROLLOUT_NETS = {"scout": "student_h160", "fast": "teacher",
                "guided": "teacher", "uniform": "ref"}


def envconfig(path=ROOT / "envConfig.json"):
    """envConfig.json's dynamics and disturbances: {'steps', 'dt' (T_final
    / steps), 'g', 'mass', 'I', 'noise_mean', 'noise_std'}."""
    cfg = json.loads(Path(path).read_text())
    plan, agent, mpc = cfg["planner_cfg"], cfg["agent_cfg"], cfg["mpc_cfg"]
    steps = int(plan["steps"])
    return dict(steps=steps, dt=plan["T_final"] / steps, g=agent["g"],
                mass=agent["mass"], I=np.asarray(agent["I"], np.float32),
                noise_mean=np.asarray(mpc["mpc_noise_mean"], np.float32),
                noise_std=np.asarray(mpc["mpc_noise_std"], np.float32))


def rollout_engine(path, net, state, sdf, sdf_start, granularity,
                   steps=None, device="cuda"):
    """The FullBatchedRolloutEngine of observation path `path` over `net`
    (and `state`'s occupancy, but for `uniform`): envConfig.json's
    dynamics and disturbances for `steps` steps (default its 12), hover
    actions [m g, 0, 0, 0], the start state of held-out pose 0, 100^2
    observations of the scene's camera."""
    env = envconfig()
    T = env["steps"] if steps is None else steps
    return FullBatchedRolloutEngine(
        actions=np.tile(np.float32([env["mass"] * env["g"], 0.0, 0.0, 0.0]),
                        (T, 1)),
        dt=env["dt"], g=env["g"], mass=env["mass"], I=env["I"], sdf=sdf,
        sdf_start=sdf_start, granularity=granularity,
        noise_mean=env["noise_mean"], noise_std=env["noise_std"],
        start_state=start_state_from_pose(holdout_poses()[0]), net=net,
        renderer_state=None if path == "uniform" else state,
        obs_render=path, obs_res=ROLLOUT_OBS, base_intrinsics=intrinsics(),
        base_res=RES, device=device)


def intrinsics(res: int = RES):
    fx = 0.5 * res / np.tan(0.5 * FOV_X)
    return (fx, fx, res / 2, res / 2)


def pose_rays(pose, device, res: int = RES):
    """Full-frame rays (rays_o, rays_d) [res^2, 3] of a raw-frame pose."""
    r = get_rays(nerf_matrix_to_ngp(pose, scale=1.0,
                                    offset=(0.0, 0.0, 0.0))[None],
                 intrinsics(res), res, res, device=device)
    return r["rays_o"][0].contiguous(), r["rays_d"][0].contiguous()


def holdout_poses():
    return [orbit_pose(th, ph, 2.4) for th, ph in HOLDOUT]


def load_teacher_net(device, scene: str = "spheres",
                     compute_dtype: str = "bfloat16"):
    """(folded teacher, the checkpoint's stored RendererState)."""
    params, stored = load_checkpoint(scene_assets(scene)["teacher"],
                                     device=device)
    cfg = replace(TEACHER_CFG, compute_dtype=compute_dtype)
    return make_network(cfg, params, device=device).to_folded(), stored


def load_ref_nets(device, scene: str = "spheres"):
    """({'ref': the reference backbone, 'ref_ml8': the same params at
    max_level 8, 'ref_f32': the same params in float32}, the checkpoint's
    stored RendererState). The three share the params' tensors."""
    params, stored = load_checkpoint(scene_assets(scene)["ref"],
                                     device=device)
    nets = {"ref": make_network(REF_CFG, params, device=device),
            "ref_ml8": make_network(replace(REF_CFG, max_level=REF_MAX_LEVEL),
                                    params, device=device),
            "ref_f32": make_network(REF_CFG_F32, params, device=device)}
    return nets, stored


def refresh(net, state, seed: int = 100, n: int = REFRESHES,
            reseed: bool = False):
    """n occupancy refreshes through `net`, jittered from one generator
    seeded `seed`, or with `reseed` the i-th from one seeded seed + i
    (bench.py refreshes with PRNGKey(100 + i); the draws differ)."""
    gen = torch.Generator(device=state.density_grid.device).manual_seed(seed)
    for i in range(n):
        if reseed:
            gen.manual_seed(seed + i)
        state = update_extra_state(net, state, generator=gen,
                                   grid_size=net.cfg.grid_size)
    return state


def serving_net(net):
    """The trained teacher `net` as the served one: the same parameters in
    TEACHER_CFG (through K3), folded."""
    return make_network(TEACHER_CFG, net.params_tree(),
                        device=net.hash.device).to_folded()


# bench.py:253-262: (distill steps, fine-tune steps) of each (hidden
# width, layers) student, and of any other
STUDENT_SCHEDULES = {(192, 6): (16000, 8000),
                     (160, 6): (24000, 12000),
                     (128, 6): (32000, 16000)}
DEFAULT_SCHEDULE = (8000, 4000)
# bench.py:326-339: the fine-tune's pool, 64 orbit poses at 128x128
POOL_POSES, POOL_RES, POOL_SEED = 64, 128, 11


def student_schedule(hidden: int, layers: int = 6):
    """(distill steps, fine-tune steps) of the student of that shape
    (bench.py `_student_schedule` without its environment override)."""
    return STUDENT_SCHEDULES.get((hidden, layers), DEFAULT_SCHEDULE)


def ray_pool(device):
    """bench.py's fine-tune pool: the rays (rays_o, rays_d) [64 * 128^2,
    3] of 64 orbit poses drawn from numpy's default_rng(11) (azimuth in
    [0, 2 pi), elevation in [0.15, 1.2), radius in [2.2, 2.6)) at 128x128
    and bench.py's field of view."""
    rng = np.random.default_rng(POOL_SEED)
    fx = 0.5 * POOL_RES / np.tan(0.5 * FOV_X)
    intr = (fx, fx, POOL_RES / 2, POOL_RES / 2)
    pool_o, pool_d = [], []
    for _ in range(POOL_POSES):
        pose = orbit_pose(rng.uniform(0, 2 * np.pi), rng.uniform(0.15, 1.2),
                          rng.uniform(2.2, 2.6))
        r = get_rays(nerf_matrix_to_ngp(pose, scale=1.0,
                                        offset=(0.0, 0.0, 0.0))[None],
                     intr, POOL_RES, POOL_RES, device=device)
        pool_o.append(r["rays_o"].reshape(-1, 3))
        pool_d.append(r["rays_d"].reshape(-1, 3))
    return torch.cat(pool_o).contiguous(), torch.cat(pool_d).contiguous()


def distill_student(teacher, state, hidden: int, layers: int = 6,
                    K: int = 16, generator=None, schedule=None,
                    on_step=None):
    """bench.py's `_get_student` without its cache: the student of
    `student_config(teacher.cfg, multires=12, hidden, layers)` distilled
    from `teacher` over `state`'s occupancy, then fine-tuned on
    `ray_pool` with K window samples, at `schedule` (distill steps,
    fine-tune steps; default student_schedule(hidden, layers)), all draws
    from `generator`. `on_step(phase, i, loss)` runs after each step of
    each phase ("distill", "finetune"). Returns (the trained unfused
    student, its params pytree, {phase: its final loss})."""
    d_steps, f_steps = schedule or student_schedule(hidden, layers)
    scfg = student_config(teacher.cfg, multires=12, hidden_dim=hidden,
                          num_layers=layers)

    def hook(phase):
        if on_step is None:
            return None
        return lambda i, loss: on_step(phase, i, loss)
    student, sparams, d_loss = distill(
        teacher, state, steps=d_steps, cfg=scfg, generator=generator,
        on_step=hook("distill"))
    pool_o, pool_d = ray_pool(state.density_bitfield.device)
    sparams, f_loss = finetune_render(
        student, sparams, teacher, state, pool_o, pool_d, steps=f_steps,
        K=K, generator=generator, on_step=hook("finetune"))
    student = make_network(scfg, sparams,
                           device=state.density_bitfield.device)
    return student, sparams, {"distill": d_loss, "finetune": f_loss}


def load_student_net(device, scene: str = "spheres", hidden: int = 160,
                     compute_dtype: str = "bfloat16"):
    """The committed student of width `hidden` of a scene."""
    path = scene_assets(scene)["students"][hidden]
    return make_network(student_cfg(hidden, compute_dtype), params_from_jax(
        load_student(path), device), device=device)


def load_students(device, scene: str = "spheres"):
    """{'student_h160': ..., 'student_h192': ..., 'student_h256': ...}, the
    nets the baked modes shade."""
    return {f"student_h{h}": load_student_net(device, scene, h)
            for h in STUDENT_WIDTHS}


def render(mode, nets, state, rays_o, rays_d, res: int = RES,
           plain_field: bool = False):
    """One frame of `mode` (a key of MODES); nets maps the mode's net name
    ('teacher', 'student_h160' / '_h192' / '_h256', 'ref', 'ref_ml8',
    'ref_f32') to its network.
    The staged modes read no occupancy (`state` may be None) and return
    the staged render's dict with the batch axis dropped: 'image' [N, 3],
    'depth' and 'aggregated_density' [N], and the last chunk's 'rgbs' and
    'sigmas'."""
    m = MODES[mode]
    net = nets[m["net"]]
    if mode in STAGED_MODES:
        out = render_staged(net, rays_o[None], rays_d[None],
                            plain_field=plain_field, **m["frame"])
        return {k: v[0] if k in ("image", "depth", "aggregated_density")
                else v for k, v in out.items()}
    if mode in MARCHED:
        return render_frame_fast(net, state, rays_o, rays_d,
                                 plain_field=plain_field, **m["frame"])
    return render_frame_guided(net, state, rays_o, rays_d, res, res,
                               plain_field=plain_field, **m["frame"])


def train_opt(**overrides):
    """TRAIN_OPT as the attribute namespace the trainer reads."""
    return SimpleNamespace(**dict(TRAIN_OPT, **overrides))


def train_splits(res: int = TRAIN_RES, n_views: int = N_TRAIN_VIEWS):
    """bench.py's spheres dataset (48 training views, 2 validation views and
    4 test views at 200x200, seed 0), in memory."""
    return generate_dataset(n_train=n_views, n_val=2, n_test=4, H=res,
                            W=res, scene="spheres")


def train_dataset(device, res: int = TRAIN_RES, n_views: int = N_TRAIN_VIEWS,
                  opt=None, splits=None, type: str = "train"):
    """A split ('train' or 'val') of `splits` (default: train_splits(res,
    n_views)) as a preloaded NeRFDataset."""
    return NeRFDataset(opt or train_opt(), splits or train_splits(res,
                                                                  n_views),
                       type=type, device=device)


def train_flagship(device, iters: int = TRAIN_ITERS, opt=None, dataset=None,
                   seed: int = 0, on_epoch=None,
                   train_gather: str = "foldrow_pallas", **cfg):
    """Train the teacher from a seeded init for `iters` steps (whole epochs
    of the dataset, as bench.py's ceil(iters / views)), then refresh its
    occupancy 4x through the trained field. `train_gather` is the dense
    fetch's route: "foldrow_pallas" (the fold through kernel K5) or
    "foldrow" (the same fold as a slice stack under autograd); `cfg`
    overrides other fields of TRAIN_CFG (fused=True: through K3; its
    compute_dtype). Returns (net, state, trainer); `on_epoch(trainer)` runs
    after every epoch."""
    opt = opt or train_opt(iters=iters, seed=seed)
    dataset = dataset or train_dataset(device, opt=opt)
    gen = torch.Generator(device=device).manual_seed(seed)
    net = make_network(replace(TRAIN_CFG, train_gather=train_gather, **cfg),
                       None, device=device, trainable=True, generator=gen)
    trainer = Trainer(opt, net, mute=True)
    loader = dataset.dataloader(torch.Generator(
        device=device).manual_seed(seed))
    trainer.train(loader, None, -(-iters // len(loader)), on_epoch=on_epoch)
    with torch.no_grad():
        net.to_folded()
        state = refresh(net, trainer.renderer_state)
    return net, state, trainer


def ref_train_opt(**overrides):
    """REF_TRAIN_OPT as the attribute namespace the trainer reads."""
    return SimpleNamespace(**dict(REF_TRAIN_OPT, **overrides))


def train_ref(device, fused: bool, iters: int = REF_TRAIN_ITERS, opt=None,
              dataset=None, seed: int = 0, on_epoch=None):
    """Train the hash-grid reference backbone from a seeded init with
    bench.py's `_train_ref_backbone` schedule, both MLPs through K4 when
    `fused` (else the plain chain), then refresh its occupancy 4x, the
    i-th jittered from seed 100 + i. Returns (net, state, trainer)."""
    opt = opt or ref_train_opt(iters=iters, seed=seed)
    dataset = dataset or train_dataset(device, opt=opt)
    gen = torch.Generator(device=device).manual_seed(seed)
    net = make_network(replace(REF_TRAIN_CFG, fused=fused), None,
                       device=device, trainable=True, generator=gen)
    trainer = Trainer(opt, net, mute=True)
    loader = dataset.dataloader(torch.Generator(
        device=device).manual_seed(seed))
    trainer.train(loader, None, -(-iters // len(loader)), on_epoch=on_epoch)
    with torch.no_grad():
        state = refresh(net, trainer.renderer_state, seed=100, reseed=True)
    return net, state, trainer


def serving_ref(net):
    """A trained reference backbone as `ref_backbone` serves it: the same
    parameters in REF_CFG (both MLPs through K4, bf16)."""
    return make_network(REF_CFG, net.params_tree(),
                        device=net.embeddings.device)
