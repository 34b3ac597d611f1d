"""The port's trainer against the JAX package's over a few hundred steps,
on the CPU: does the port train like the reference beyond the first few
steps?

Both trainers start from one JAX `init` and see the same batches (rays and
pixels of a small in-memory spheres set) and the same random draws (the
JAX trainer's own background, march and refresh jitter, recomputed from
its key and handed to the port). Nothing else is handed across: each
trainer refreshes its own occupancy and marches through it, so the two
runs drift apart as bf16 roundings and the last bits of XLA's contracted
FMAs add up. JAX runs with other trainer seeds (other draws) measure how
far two runs of the reference itself lie apart, the yardstick for the
bounds.

The net is the small mip spec of tests/test_trainer.py (5 levels of 2
channels from base 4, dense to 16, 2^10 hash rows, a 16^3 grid) in
bfloat16 with `train_gather="foldrow_pallas"`; 16 views of 32x32, 256 rays
a step, 320 steps with the budget phase switch at step 128, so the run
crosses it and the partial refresh. The held-out score is the PSNR of the
port's `fast` frame, through each run's own trained parameters and
occupancy, on the two validation views. The same run on a small hash-grid
`NeRFNetwork` (4 levels of 2 channels from base 4, a 2^10 table, 16-wide
MLPs through K4, bfloat16: the training CLI's `-O --ff` route) checks K4's
backward and the encode's over the same steps.

Run as a script from the repo's root (`PYTHONPATH=. python
tests/test_torch_train_drift.py [hashgrid]`) to print the loss windows and
the PSNRs.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.train.trainer import Trainer as JTrainer
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.data.provider import NeRFDataset
from nerfsafetyvalidation_tpu_torch.data.synthetic import generate_dataset
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.train import trainer as TT
from nerfsafetyvalidation_tpu_torch.train.metrics import PSNRMeter

torch.set_num_threads(1)

G = 16
N_RAYS = 256
RES = 32
STEPS, WARMUP = 320, 128
WINDOW = 64                     # steps a loss window averages
NET = dict(encoding="mipfold", bound=1.0, num_levels=5, level_dim=2,
           base_resolution=4, fold_max_scale=16, log2_hashmap_size=10,
           grid_size=G, grid_ray=True, density_thresh=10.0,
           train_gather="foldrow_pallas", compute_dtype="bfloat16")
HASH_NET = dict(encoding="hashgrid", bound=1.0, num_levels=4, level_dim=2,
                base_resolution=4, log2_hashmap_size=10,
                desired_resolution=32, hidden_dim=16, hidden_dim_color=16,
                grid_size=G, grid_ray=True, density_thresh=10.0,
                compute_dtype="bfloat16", fused=True)


def _opt(seed):
    return types.SimpleNamespace(
        lr=1e-2, iters=STEPS, update_extra_interval=16, grid_max_samples=24,
        grid_samples_per_hit=2, grid_sample_budget_per_ray=12,
        grid_warmup_steps=WARMUP, grid_max_samples_after_warmup=16,
        grid_budget_after_warmup=8, max_steps=256, dt_gamma=1.0 / 64,
        seed=seed, color_space="srgb", scale=1.0, offset=(0.0, 0.0, 0.0),
        num_rays=N_RAYS, preload=True, fp16=False)


def _data():
    splits = generate_dataset(n_train=16, n_val=2, n_test=1, H=RES, W=RES)
    opt = _opt(0)
    return (NeRFDataset(opt, splits, "train", device="cpu"),
            NeRFDataset(opt, splits, "val", device="cpu"))


def _batches(train):
    """The same STEPS batches for every run: an image and its pixels drawn
    by numpy from a seed."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        b = train.collate([int(rng.integers(len(train)))],
                          inds=torch.from_numpy(
                              rng.integers(0, RES * RES, N_RAYS)))
        out.append({k: b[k] for k in ("rays_o", "rays_d", "images")})
    return out


def _refresh_blocks(trainer):
    """(n_blocks, block) of the refresh due now, as both trainers pick it
    (the JAX trainer's _maybe_refresh; the port's is the same rule)."""
    if trainer.global_step <= WARMUP:
        return 1, 0
    return 4, getattr(trainer, "_grid_block", 0)


def _jax_draws(trainer):
    """The draws the JAX trainer makes next from its key: the refresh's
    jitter when one is due, then the step's background and march jitter
    (the JAX trainer's _maybe_refresh and train_step; renderer.py
    update_extra_state; marching.py march_rays)."""
    key, jitter = trainer.key, None
    if trainer.global_step % 16 == 0:
        n_blocks, _ = _refresh_blocks(trainer)
        key, sub = jax.random.split(key)
        _, sub = jax.random.split(sub)
        jitter = [torch.from_numpy(np.array(jax.random.uniform(
            sub, (G ** 3 // n_blocks, 3))))]
    _, sub = jax.random.split(key)
    k_bg, k_march = jax.random.split(sub)
    bg = torch.from_numpy(np.array(jax.random.uniform(k_bg, (1, N_RAYS, 3))))
    perturb = torch.from_numpy(np.array(jax.random.uniform(k_march,
                                                           (N_RAYS,))))
    return jitter, bg, perturb


def _state_t(s):
    return TR.RendererState(
        density_bitfield=torch.from_numpy(np.array(s.density_bitfield)),
        density_grid=torch.from_numpy(np.array(s.density_grid)),
        mean_density=torch.from_numpy(np.array(s.mean_density)),
        iter_density=torch.from_numpy(np.array(s.iter_density)),
        skip_grid=None if s.skip_grid is None
        else torch.from_numpy(np.array(s.skip_grid)))


def _psnr(params, state, val, net_kw=NET):
    """Mean PSNR of the port's `fast` frame on the validation views, from
    a JAX-layout params pytree and a port RendererState."""
    net = t_make(TConfig(**net_kw), params_from_jax(params, device="cpu"),
                 device="cpu")
    if hasattr(net, "to_folded"):
        net.to_folded()
    meter = PSNRMeter()
    with torch.no_grad():
        for i in range(len(val)):
            b = val.collate([i], inds=torch.arange(RES * RES))
            out = TR.render_frame_fast(
                net, state, b["rays_o"].reshape(-1, 3),
                b["rays_d"].reshape(-1, 3), tile=RES * RES, max_samples=16,
                max_steps=256, dt_gamma=1.0 / 64)
            img = b["images"].reshape(-1, 4)
            gt = img[:, :3] * img[:, 3:] + (1 - img[:, 3:])
            meter.update(out["image"].reshape(-1, 3), gt)
    return meter.measure()


def _run(init, train, batches, val, seed, port, net_kw=NET):
    """STEPS iterations of the JAX trainer (seed `seed`) and, with `port`,
    of the port's on the same batches and the JAX trainer's draws. Returns
    {'jax' | 'port': (per-step losses, held-out PSNR)}."""
    net_j = j_make(JConfig(**net_kw))
    tr_j = JTrainer("d", _opt(seed), net_j,
                    params=jax.tree_util.tree_map(jnp.asarray, init),
                    workspace=None, use_checkpoint="scratch", mute=True)
    tr_j.renderer_state = JR.mark_untrained_grid(
        net_j.cfg, tr_j.renderer_state, train.poses, train.intrinsics,
        grid_size=G)
    tr_t = None
    if port:
        net_t = t_make(TConfig(**net_kw), params_from_jax(init,
                                                          device="cpu"),
                       device="cpu", trainable=True)
        tr_t = TT.Trainer(_opt(seed), net_t, mute=True)
        tr_t.start(train)
    loss_j, loss_t = [], []
    for data in batches:
        if tr_t is not None:
            jitter, bg, perturb = _jax_draws(tr_j)
            loss_t.append(float(tr_t.iteration(data, bg=bg, perturb=perturb,
                                               jitter=jitter)[1]))
        tr_j._maybe_refresh()
        tr_j.global_step += 1
        loss_j.append(float(tr_j.train_step(
            {k: jnp.asarray(v.numpy()) for k, v in data.items()})[1]))
    out = {"jax": (np.array(loss_j), _psnr(
        jax.tree_util.tree_map(np.asarray, tr_j.params),
        _state_t(tr_j.renderer_state), val, net_kw))}
    if tr_t is not None:
        p = tr_t.net.params_tree()
        out["port"] = (np.array(loss_t), _psnr(
            jax.tree_util.tree_map(lambda w: w.detach().numpy(), p),
            tr_t.renderer_state, val, net_kw))
    return out


def _windows(losses):
    return losses.reshape(-1, WINDOW).mean(axis=1)


def test_port_trains_like_jax():
    """Seed 0. Measured (the script's output, seeds 0, 1 and 2, each a JAX
    run and a port run with its draws): the first window's mean losses
    0.01-0.12% apart; every window 0.01-17.4% apart (8.4% at most at seed
    0), where the JAX runs of seeds 0, 1 and 2 lie up to 10.2% apart from
    each other; the last window 0.24 of the first; held-out PSNR: port
    17.43 / 17.57 / 17.50 dB, JAX 17.26 / 17.34 / 17.41 dB (port - JAX:
    +0.18, +0.23, +0.09 dB; the JAX runs span 0.16 dB). Bounds: the first
    window 1%, every window 25%, the last window under half the first,
    the PSNRs 0.5 dB."""
    train, val = _data()
    init = jax.tree_util.tree_map(
        np.asarray, j_make(JConfig(**NET)).init(jax.random.PRNGKey(0)))
    runs = _run(init, train, _batches(train), val, seed=0, port=True)
    (l_j, p_j), (l_t, p_t) = runs["jax"], runs["port"]
    assert np.isfinite(l_t).all() and np.isfinite(p_t)
    w_j, w_t = _windows(l_j), _windows(l_t)
    rel = np.abs(w_t - w_j) / w_j
    assert rel[0] <= 0.01, rel
    assert rel.max() <= 0.25, rel
    assert w_t[-1] < 0.5 * w_t[0], w_t
    assert abs(p_t - p_j) <= 0.5, (p_t, p_j)


def test_port_trains_the_hash_grid_net_like_jax():
    """The hash-grid net through K4 (its plain forward and recompute
    backward on the CPU), seed 0. Measured (the script's output with
    `hashgrid`, seeds 0, 1 and 2): the first window's mean losses 0.1-0.4%
    apart; every window 0.1-14.1% apart (0.7% at most at seed 0), where the
    JAX runs of seeds 0, 1 and 2 lie up to 8.8% apart from each other;
    held-out PSNR: port 16.09 / 16.17 / 15.21 dB, JAX 16.07 / 16.18 /
    15.87 dB (port - JAX: +0.02, -0.01, -0.67 dB; the JAX runs span 0.31
    dB). The mip-fold net's bounds."""
    train, val = _data()
    init = jax.tree_util.tree_map(
        np.asarray, j_make(JConfig(**HASH_NET)).init(jax.random.PRNGKey(0)))
    runs = _run(init, train, _batches(train), val, seed=0, port=True,
                net_kw=HASH_NET)
    (l_j, p_j), (l_t, p_t) = runs["jax"], runs["port"]
    assert np.isfinite(l_t).all() and np.isfinite(p_t)
    w_j, w_t = _windows(l_j), _windows(l_t)
    rel = np.abs(w_t - w_j) / w_j
    assert rel[0] <= 0.01, rel
    assert rel.max() <= 0.25, rel
    assert w_t[-1] < 0.5 * w_t[0], w_t
    assert abs(p_t - p_j) <= 0.5, (p_t, p_j)


if __name__ == "__main__":
    import sys
    import time
    jax.config.update("jax_platforms", "cpu")
    net_kw = HASH_NET if sys.argv[1:] == ["hashgrid"] else NET
    t0 = time.perf_counter()
    train, val = _data()
    batches = _batches(train)
    init = jax.tree_util.tree_map(
        np.asarray, j_make(JConfig(**net_kw)).init(jax.random.PRNGKey(0)))
    for seed in (0, 1, 2):
        for name, (losses, psnr) in _run(init, train, batches, val, seed,
                                         True, net_kw).items():
            print(f"{name} seed {seed}: loss windows of {WINDOW} steps "
                  f"{_windows(losses).round(6).tolist()}; held-out PSNR "
                  f"{psnr:.4f} dB")
    print(f"{time.perf_counter() - t0:.1f} s")
