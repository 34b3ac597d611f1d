"""The port's training loop against the JAX package's, on the CPU: Adam
with the decaying learning rate against optax; the partial occupancy
refresh and `mark_untrained_grid`; and whole trainer steps (refresh,
background draw, march with jitter, budgeted compaction, the field under
autograd with the fold built through K5's plain versions, MSE, backward,
update) against the JAX `Trainer` with the JAX trainer's own draws handed
to the port.

The net is the small mip spec of tests/test_trainer.py (5 levels of 2
channels from base 4, dense to 16, 2^10 hash rows, a 16^3 grid) with
`train_gather="foldrow_pallas"`, its weights drawn by numpy from a seed
with the sigma lane made positive (a carved field: at JAX's own init every
density sits at the mean-density threshold, where a last-bit difference
flips bits). The rays have direction components 0 or powers of two, so
the march takes the same path in both packages (XLA on the CPU contracts
o + t * d into an FMA; PyTorch does not)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.train.trainer import Trainer as JTrainer
from nerfsafetyvalidation_tpu.train.trainer import default_optimizer
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.ops.hopper import fold_build as K5
from nerfsafetyvalidation_tpu_torch.train import trainer as TT

torch.set_num_threads(1)

G = 16
N_RAYS = 256
LR = 1e-2
NET = dict(encoding="mipfold", bound=1.0, num_levels=5, level_dim=2,
           base_resolution=4, fold_max_scale=16, log2_hashmap_size=10,
           grid_size=G, grid_ray=True, density_thresh=10.0,
           train_gather="foldrow_pallas")


def _opt(**kw):
    return types.SimpleNamespace(**dict(
        lr=LR, iters=100, update_extra_interval=16, grid_max_samples=24,
        grid_samples_per_hit=2, grid_sample_budget_per_ray=12,
        max_steps=256, dt_gamma=1.0 / 64, seed=0, color_space="srgb"), **kw)


def _params(net_j, seed=3):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["sigma_net"][-1][:, 0] = np.abs(p["sigma_net"][-1][:, 0])
    return p


def _leaves_t(net):
    """The port's parameters in the JAX pytree's leaf order."""
    ws = net.param_list()
    return jax.tree_util.tree_leaves(
        {"encoder": {"pyramid": ws[:3], "hash": ws[3]},
         "sigma_net": ws[4:6], "color_net": ws[6:]})


def _batch(seed):
    """One image's batch: rays from z = -2.5 into the box, RGBA pixels."""
    rng = np.random.default_rng(seed)
    n = N_RAYS
    o = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                  np.full(n, -2.5)], -1).astype(np.float32)
    side = np.array([0.0, 0.0625, -0.0625, 0.125, -0.125, 0.25])
    d = np.stack([rng.choice(side, n), rng.choice(side, n), np.ones(n)],
                 -1).astype(np.float32)
    img = np.concatenate([rng.uniform(0, 1, (n, 3)),
                          rng.uniform(size=(n, 1)) > 0.3], -1)
    return o[None], d[None], img[None].astype(np.float32)


def _jax_draws(key, refresh):
    """The draws the JAX trainer makes next from its key: the refresh's
    jitter (one cascade) when a refresh is due, then the step's background
    and march jitter (trainer.py:305, :166-170; renderer.py update_extra_
    state; marching.py:72-74)."""
    jitter = None
    if refresh:
        key, sub = jax.random.split(key)
        _, sub = jax.random.split(sub)
        jitter = [torch.from_numpy(np.array(
            jax.random.uniform(sub, (G ** 3, 3))))]
    key, sub = jax.random.split(key)
    k_bg, k_march = jax.random.split(sub)
    bg = torch.from_numpy(np.array(jax.random.uniform(k_bg,
                                                      (1, N_RAYS, 3))))
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


def _trainers(dtype):
    net_j = j_make(JConfig(**NET, compute_dtype=dtype))
    p = _params(net_j)
    tr_j = JTrainer("t", _opt(), net_j,
                    params=jax.tree_util.tree_map(jnp.asarray, p),
                    workspace=None, use_checkpoint="scratch", mute=True)
    net_t = t_make(TConfig(**NET, compute_dtype=dtype),
                   params_from_jax(p, device="cpu"), device="cpu",
                   trainable=True)
    return tr_j, TT.Trainer(_opt(), net_t)


def _run_steps(dtype, n_steps):
    """n_steps iterations of both trainers on the same batches. In bf16 the
    port is handed JAX's refreshed state (see the test). Returns [(loss_j,
    loss_t, params_j, params_t, bytes of the refreshed bitfields that
    differ)] per step."""
    tr_j, tr_t = _trainers(dtype)
    out = []
    for step in range(n_steps):
        jitter, bg, perturb = _jax_draws(tr_j.key,
                                         tr_j.global_step % 16 == 0)
        o, d, im = _batch(step)
        tr_j._maybe_refresh()
        tr_j.global_step += 1
        _, loss_j = tr_j.train_step({"rays_o": jnp.asarray(o),
                                     "rays_d": jnp.asarray(d),
                                     "images": jnp.asarray(im)})
        data = {"rays_o": torch.from_numpy(o), "rays_d": torch.from_numpy(d),
                "images": torch.from_numpy(im)}
        if dtype == "float32":
            _, loss_t = tr_t.iteration(data, bg=bg, perturb=perturb,
                                       jitter=jitter)
            s_t = tr_t.renderer_state
        else:
            tr_t._maybe_refresh(jitter)
            s_t = tr_t.renderer_state
            tr_t.global_step += 1
            tr_t.renderer_state = _state_t(tr_j.renderer_state)
            _, loss_t = tr_t.train_step(data, bg=bg, perturb=perturb)
        flips = int((s_t.density_bitfield.numpy() != np.asarray(
            tr_j.renderer_state.density_bitfield)).sum())
        out.append((float(loss_j), float(loss_t),
                    [np.asarray(w) for w in
                     jax.tree_util.tree_leaves(tr_j.params)],
                    [w.detach().numpy().copy() for w in _leaves_t(tr_t.net)],
                    flips))
    return out


def test_trainer_steps_match_jax_float32():
    """Three iterations in float32, the refresh included. Measured: losses
    1.4e-7 relative; parameters 2.3e-6 apart after two steps; after the
    third, 0.32 lr at most, and more than 0.1 lr on 0.012% of the hash
    entries and on none elsewhere (Adam divides each gradient by its own
    running size, so gradients that are near zero and differ in their last
    bits move further). Bounds: losses 1e-6 relative; parameters 1e-5
    after two steps; after three, lr / 2, and more than 0.1 lr on at most
    0.1% of each tensor's entries."""
    launches = (K5.LAUNCHES, K5.LAUNCHES_BWD)
    steps = _run_steps("float32", 3)
    assert (K5.LAUNCHES, K5.LAUNCHES_BWD) == launches    # plain on the CPU
    for i, (l_j, l_t, p_j, p_t, flips) in enumerate(steps):
        assert flips == 0
        np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
        for a, b in zip(p_t, p_j):
            if i < 2:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            else:
                err = np.abs(a - b)
                assert float(err.max()) <= LR / 2
                assert float((err > 0.1 * LR).mean()) <= 1e-3
    assert steps[-1][1] < steps[0][1]


def test_trainer_steps_match_jax_bfloat16():
    """Three iterations in bfloat16. The refreshed bitfield differs from
    JAX's in a few bytes (measured 6 of 512: densities within one bf16
    step of the threshold, from the MLP's sums in another order), and a
    different bit sends rays through other cells; so after each refresh
    the port is handed JAX's state, and the test holds the step itself.
    Measured: losses 6.2e-5 relative at most; after the first update 0.3-
    0.9% of each tensor's entries differ, each by 2 lr (a gradient near
    zero whose bf16-rounded terms change its sign: Adam's first step is
    lr * sign(g)); after the second and third, 0.9% of each tensor's
    entries at most lie more than 2 lr apart (5.2 lr at most). Bounds:
    refreshed bitfield 2% of its bytes; losses 5e-4 relative; after the
    first update 2% of the entries, by 2 lr at most; after every update,
    at most 2% of each tensor's entries more than 2 lr apart."""
    for i, (l_j, l_t, p_j, p_t, flips) in enumerate(
            _run_steps("bfloat16", 3)):
        assert flips <= 0.02 * (G ** 3 // 8)
        np.testing.assert_allclose(l_t, l_j, rtol=5e-4)
        for a, b in zip(p_t, p_j):
            err = np.abs(a - b)
            if i == 0:
                assert float(err.max()) <= 2 * LR * (1 + 1e-5)
                assert float((err > 1e-6).mean()) <= 0.02
            assert float((err > 2 * LR).mean()) <= 0.02


def test_adam_and_decay_match_optax():
    """torch Adam(0.9, 0.99, eps 1e-15) + LambdaLR stepped after every
    update against the JAX package's optax chain, over 40 fixed gradients
    with iters=10 (the decay reaches its floor of 0.1 at step 10).
    Measured: 6.1e-8 of the parameters' largest size. Bound: 1e-7."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(64, 32)).astype(np.float32)
    grads = rng.normal(size=(40, 64, 32)).astype(np.float32)
    grads[:, :4] *= 1e-6                          # tiny gradients too
    opt = types.SimpleNamespace(lr=1e-2, iters=10)
    tx = default_optimizer(opt)
    w_j = jnp.asarray(w0)
    state = tx.init(w_j)
    w_t = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    optimizer, scheduler = TT.default_optimizer([w_t], opt)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, w_j)
        w_j = optax.apply_updates(w_j, updates)
        w_t.grad = torch.from_numpy(g)
        optimizer.step()
        scheduler.step()
    err = np.abs(w_t.detach().numpy() - np.asarray(w_j)).max()
    assert err <= 1e-7 * np.abs(w0).max(), err
    assert scheduler.get_last_lr()[0] == pytest.approx(1e-3)


@pytest.fixture(scope="module")
def teacher():
    """A JAX teacher and the port's, one set of params, float32."""
    net_j = j_make(JConfig(**NET))
    p = _params(net_j)
    p_j = jax.tree_util.tree_map(jnp.asarray, p)
    net_t = t_make(TConfig(**NET), params_from_jax(p, device="cpu"),
                   device="cpu")
    return net_j, net_j.to_folded(p_j), net_t.to_folded()


def test_partial_refresh_matches_jax(teacher):
    """A full refresh, then the four morton-strided blocks of the partial
    refresh in rotation, with JAX's own jitter handed in: the bitfield and
    the skip grid equal after every refresh, the density grid within
    1e-6 relative (the probe points come out of an FMA in XLA)."""
    net_j, fp_j, net_t = teacher
    s_j = JR.RendererState.create(1, G)
    s_t = _state_t(s_j)
    for i, (n_blocks, block) in enumerate([(1, 0), (4, 0), (4, 1), (4, 2),
                                           (4, 3)]):
        key = jax.random.PRNGKey(200 + i)
        _, sub = jax.random.split(key)
        u = np.array(jax.random.uniform(sub, (G ** 3 // n_blocks, 3)))
        s_j = JR.update_extra_state(net_j, fp_j, s_j, key, grid_size=G,
                                    n_blocks=n_blocks, block=block)
        before = s_t.density_grid.clone()
        s_t = TR.update_extra_state(net_t, s_t, jitter=[torch.from_numpy(u)],
                                    grid_size=G, n_blocks=n_blocks,
                                    block=block)
        np.testing.assert_allclose(s_t.density_grid.numpy(),
                                   np.asarray(s_j.density_grid), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(s_t.density_bitfield.numpy(),
                                      np.asarray(s_j.density_bitfield))
        np.testing.assert_array_equal(s_t.skip_grid.numpy(),
                                      np.asarray(s_j.skip_grid))
        if n_blocks > 1:       # only the block's cells were probed
            touched = (s_t.density_grid != before).numpy()[0]
            assert touched.sum() > 0
            assert not touched[np.arange(G ** 3) % 4 != block].any()
    occ = np.unpackbits(np.asarray(s_j.density_bitfield)).mean()
    assert 0.05 < occ < 0.95, occ


def test_mark_untrained_grid_matches_jax():
    """Cells no camera sees become -1: six cameras around the box at
    radius 2.4 looking in with a narrow field of view, so the corners of
    the grid are unseen."""
    cfg = JConfig(**NET)
    poses = []
    for k in range(6):
        th = 2 * np.pi * k / 6
        c = np.array([2.4 * np.cos(th), 2.4 * np.sin(th), 0.3])
        fwd = -c / np.linalg.norm(c)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, fwd, c
        poses.append(m)
    poses = np.stack(poses).astype(np.float32)
    intr = (120.0, 120.0, 16.0, 16.0)
    s_j = JR.mark_untrained_grid(cfg, JR.RendererState.create(1, G), poses,
                                 intr, grid_size=G)
    s_t = TR.mark_untrained_grid(TConfig(**NET),
                                 TR.RendererState.create(1, G, "cpu"),
                                 poses, intr, grid_size=G)
    grid = np.asarray(s_j.density_grid)
    np.testing.assert_array_equal(s_t.density_grid.numpy(), grid)
    assert 0.01 < (grid < 0).mean() < 0.9
    assert s_t.skip_grid is None
