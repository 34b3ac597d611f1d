"""Training the hash-grid `NeRFNetwork` in the port against the JAX
package on the CPU: `hash_grid_init` and `NeRFNetwork.init`; the encode's
gradient with respect to the float32 table through the cast to the
compute dtype; the gradient of a uniform-sampling render through the
fused field (K4's plain forward and its recompute backward, the encode's
scatter); and whole steps of the port's `Trainer` against the JAX
`Trainer` with the JAX trainer's draws handed in, on two routes of the
fused `NeRFNetwork` (the config's `fused=True`, built directly): bfloat16
through the occupancy march with compaction ("O_ff", the training CLI's
`-O` route) and float32 through the uniform `run` with jittered samples
and upsampling ("ff", the CLI's route without `-O`; the CLI's `--ff`
itself builds `NeRFNetworkFF`, tests/test_torch_network_ff.py).

The net is small (4 levels x 2 channels from base 4, a 2^10 table, 16-wide
MLPs, a 16^3 grid), its weights drawn by numpy from a seed (the table
scaled up and sigma's lane made positive: a field with structure). The
march's rays have direction components 0 or powers of two and the uniform
route's run along the axes, so that both packages place the samples alike
(XLA on the CPU contracts a * b + c into FMAs; PyTorch does not)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.ops import hash_encoding as JH
from nerfsafetyvalidation_tpu.train.trainer import Trainer as JTrainer
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.models.network import grid_spec_of
from nerfsafetyvalidation_tpu_torch.ops import hash_encoding as TH
from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as K4
from nerfsafetyvalidation_tpu_torch.train import trainer as TT

torch.set_num_threads(1)

G = 16
LR = 1e-2
NET = dict(encoding="hashgrid", bound=1.0, num_levels=4, level_dim=2,
           base_resolution=4, log2_hashmap_size=10, desired_resolution=32,
           hidden_dim=16, hidden_dim_color=16, fused=True, grid_size=G,
           density_thresh=10.0)
# the two routes: bf16 marched (-O's) and f32 uniform
ROUTES = {"O_ff": dict(compute_dtype="bfloat16", grid_ray=True),
          "ff": dict(compute_dtype="float32", grid_ray=False)}
N_MARCH, N_UNIFORM, STEPS, UPSAMPLE = 256, 64, 32, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(net_j, seed=4):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.4, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] *= 2.0
    p["sigma_net"][-1][:, 0] = np.abs(p["sigma_net"][-1][:, 0])
    return p


def _opt(**kw):
    return types.SimpleNamespace(**dict(dict(
        lr=LR, iters=100, update_extra_interval=16, grid_max_samples=24,
        grid_samples_per_hit=2, grid_sample_budget_per_ray=12,
        max_steps=256, dt_gamma=1.0 / 64, seed=0, color_space="srgb",
        num_steps=STEPS, upsample_steps=UPSAMPLE), **kw))


# ------------------------------------------------------------------ init


def test_hash_grid_init_shape_and_range():
    """The reference spec's table: offsets[-1] rows of level_dim, uniform
    in +-1e-4 (grid.py:133-135), from the generator: one seed gives one
    table."""
    spec = TH.HashGridSpec.make(num_levels=16, level_dim=2,
                                log2_hashmap_size=19,
                                desired_resolution=2048)
    want = JH.HashGridSpec.make(num_levels=16, level_dim=2,
                                log2_hashmap_size=19,
                                desired_resolution=2048)
    emb = TH.hash_grid_init(torch.Generator().manual_seed(0), spec)
    assert tuple(emb.shape) == (want.offsets[-1], 2) == (6119864, 2)
    assert emb.dtype == torch.float32
    assert float(emb.abs().max()) <= 1e-4 and float(emb.std()) > 5e-5
    again = TH.hash_grid_init(torch.Generator().manual_seed(0), spec)
    assert torch.equal(emb, again)


def test_network_init_shapes_and_ranges():
    """`NeRFNetwork.init` (the reference's default net: 16 levels x 2, a
    32 -> 64 -> 16 sigma net, a 31 -> 64 -> 64 -> 3 color net) gives the
    JAX init's shapes in its order, each [in, out] weight uniform in
    +-1/sqrt(in); the net is trainable, and one seed gives one net. The
    tiled grid, no encoding and the background net (refused here before
    they were ported) draw the JAX init's shapes too."""
    cfg = dict(encoding="hashgrid", bound=1.0)
    shapes = jax.eval_shape(j_make(JConfig(**cfg)).init,
                            jax.random.PRNGKey(0))
    net = t_make(TConfig(**cfg), None, device="cpu", trainable=True,
                 generator=torch.Generator().manual_seed(3))
    leaves = net.param_list()
    assert [tuple(w.shape) for w in leaves] == \
        [tuple(s.shape) for s in TT.param_leaves(shapes)]
    assert [tuple(w.shape) for w in leaves[1:]] == [
        (32, 64), (64, 16), (31, 64), (64, 64), (64, 3)]
    assert float(leaves[0].detach().abs().max()) <= 1e-4
    for w in leaves[1:]:
        bound = 1.0 / np.sqrt(w.shape[0])
        assert float(w.detach().abs().max()) <= bound
        assert float(w.detach().abs().max()) > 0.9 * bound
    assert all(w.requires_grad for w in leaves)
    twin = t_make(TConfig(**cfg), None, device="cpu",
                  generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(leaves, twin.param_list()))
    assert not any(w.requires_grad for w in twin.param_list())
    # the other encodings and the background net draw JAX's shapes too
    for other in (dict(encoding="tiledgrid"), dict(encoding="None"),
                  dict(bg_radius=1.5)):
        net = t_make(TConfig(**dict(cfg, **other)), None, device="cpu",
                     generator=torch.Generator().manual_seed(3))
        shapes = jax.eval_shape(j_make(JConfig(**dict(cfg, **other))).init,
                                jax.random.PRNGKey(0))
        assert [tuple(w.shape) for w in net.param_list()] == \
            [tuple(s.shape) for s in TT.param_leaves(shapes)]


# ------------------------------------------------------------- gradients


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_gradient_matches_jax(dtype):
    """d(sum(g * encode(table.astype(dtype), x))) / d(table), the table
    float32, against jax.vjp of the JAX encode, with 10% of the points
    outside the box (they encode to zero and send no gradient). Each row
    sums its duplicates, in bfloat16 in bf16, in an order neither package
    promises. Measured: equal, bit for bit, in both dtypes. Bounds 1e-5
    (float32) and 2e-2 (bfloat16, a few bf16 roundings of the sums) of the
    largest entry."""
    spec_t = grid_spec_of(TConfig(**NET))
    spec_j = JH.HashGridSpec.make(
        input_dim=3, num_levels=4, level_dim=2, base_resolution=4,
        log2_hashmap_size=10, desired_resolution=32)
    rng = np.random.default_rng(1)
    emb = rng.normal(0, 0.5, (spec_j.offsets[-1], 2)).astype(np.float32)
    x = rng.uniform(-1.1, 1.1, (3000, 3)).astype(np.float32)
    g = rng.normal(size=(3000, spec_j.output_dim)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda e: JH.hash_grid_encode(e.astype(jdt),
                                                   jnp.asarray(x), spec_j),
                     jnp.asarray(emb))
    want = np.asarray(vjp(jnp.asarray(g).astype(jdt))[0])
    leaf = torch.tensor(emb, requires_grad=True)
    out = TH.hash_grid_encode(leaf.to(getattr(torch, dtype)),
                              torch.from_numpy(x), spec_t)
    (got,) = torch.autograd.grad(out, leaf, torch.from_numpy(g).to(
        out.dtype))
    assert got.dtype == torch.float32
    gap = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert gap <= (1e-5 if dtype == "float32" else 2e-2), gap
    assert np.array_equal(got.numpy() == 0, want == 0)


def _rays(n, seed):
    """Rays along the axis directions from 3 away from the box (a quarter
    miss it): sample positions exact in both packages."""
    rng = np.random.default_rng(seed)
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    o = rng.uniform(-1.15, 1.15, (n, 3))
    d = np.zeros((n, 3))
    o[np.arange(n), axis] = -3.0 * sign
    d[np.arange(n), axis] = sign
    return o.astype(np.float32), d.astype(np.float32)


def _nets(route):
    cfg = dict(NET, **ROUTES[route])
    net_j = j_make(JConfig(**cfg))
    p = _params(net_j)
    net_t = t_make(TConfig(**cfg), params_from_jax(p, device="cpu"),
                   device="cpu", trainable=True)
    return net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_render_gradients_match_jax(route):
    """d(sum(g * image)) / d(params) of the uniform `run` (jittered
    samples and 16 upsampled ones, JAX's draws handed in) through the
    fused field, for the table and every weight, against jax.grad of the
    JAX `run`. Measured: float32 8.4e-7 of each tensor's largest gradient;
    bfloat16 1.1e-3 (the sums' order lands a value on the neighbouring
    bf16 step now and then, and a weight near the colour mask's 1e-4 may
    fall on its other side). Bounds 1e-5 and 1e-2."""
    net_j, p_j, net_t = _nets(route)
    o, d = _rays(N_UNIFORM, 6)
    g = np.random.default_rng(2).normal(size=(N_UNIFORM, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)

    def loss_j(p):
        out = JR.run(net_j, p, jnp.asarray(o), jnp.asarray(d),
                     num_steps=STEPS, upsample_steps=UPSAMPLE, perturb=True,
                     key=key, training=True)
        return jnp.sum(out["image"] * jnp.asarray(g))

    want = TT.param_leaves(jax.grad(loss_j)(p_j))
    k1, s1 = jax.random.split(key)
    _, s2 = jax.random.split(k1)
    draws = {"perturb": _t(jax.random.uniform(s1, (N_UNIFORM, STEPS))),
             "pdf": _t(jax.random.uniform(s2, (N_UNIFORM, UPSAMPLE)))}
    before = K4.LAUNCHES + K4.LAUNCHES_F32
    out = TR.run(net_t, _t(o), _t(d), num_steps=STEPS,
                 upsample_steps=UPSAMPLE, perturb=True, training=True,
                 draws=draws)
    got = torch.autograd.grad((out["image"] * torch.from_numpy(g)).sum(),
                              net_t.param_list())
    assert K4.LAUNCHES + K4.LAUNCHES_F32 == before       # CPU: plain K4
    bound = 1e-5 if route == "ff" else 1e-2
    for a, b in zip(got, want):
        b = np.asarray(b)
        gap = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert gap <= bound, gap


# ---------------------------------------------------------- trainer steps


def _batch(route, seed):
    """One image's batch: the march's rays from z = -2.5 with power-of-two
    directions, or the uniform route's axis rays; RGBA pixels."""
    rng = np.random.default_rng(seed)
    if route == "O_ff":
        n = N_MARCH
        o = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      np.full(n, -2.5)], -1).astype(np.float32)
        side = np.array([0.0, 0.0625, -0.0625, 0.125, -0.125, 0.25])
        d = np.stack([rng.choice(side, n), rng.choice(side, n), np.ones(n)],
                     -1).astype(np.float32)
    else:
        n = N_UNIFORM
        o, d = _rays(n, seed + 10)
    img = np.concatenate([rng.uniform(0, 1, (n, 3)),
                          rng.uniform(size=(n, 1)) > 0.3], -1)
    return o[None], d[None], img[None].astype(np.float32)


def _jax_draws(route, key, refresh):
    """The draws the JAX trainer makes next from its key (trainer.py:305,
    :166-170, :202-206): the refresh's jitter when one is due (one
    cascade), then the step's background and, marched, the march jitter,
    or, uniform, the samples' jitter and the pdf's uniforms (renderer.py
    :105-107, :125-128)."""
    jitter = None
    if refresh:
        key, sub = jax.random.split(key)
        _, sub = jax.random.split(sub)
        jitter = [_t(jax.random.uniform(sub, (G ** 3, 3)))]
    key, sub = jax.random.split(key)
    k_bg, k_render = jax.random.split(sub)
    n = N_MARCH if route == "O_ff" else N_UNIFORM
    bg = _t(jax.random.uniform(k_bg, (1, n, 3)))
    if route == "O_ff":
        return jitter, bg, _t(jax.random.uniform(k_render, (n,))), None
    k1, s1 = jax.random.split(k_render)
    _, s2 = jax.random.split(k1)
    return jitter, bg, None, {
        "perturb": _t(jax.random.uniform(s1, (n, STEPS))),
        "pdf": _t(jax.random.uniform(s2, (n, UPSAMPLE)))}


def _state_t(s):
    return TR.RendererState(
        density_bitfield=_t(s.density_bitfield),
        density_grid=_t(s.density_grid), mean_density=_t(s.mean_density),
        iter_density=_t(s.iter_density),
        skip_grid=None if s.skip_grid is None else _t(s.skip_grid))


def _run_steps(route, n_steps):
    """n_steps iterations of both trainers on the same batches, JAX's draws
    handed to the port; the marched route is handed JAX's refreshed state
    too (the bitfield can differ near the threshold, see the mip
    teacher's tests/test_torch_trainer.py). Returns [(loss_j, loss_t,
    params_j, params_t)] per step, the parameters in param_list order."""
    net_j, p_j, net_t = _nets(route)
    tr_j = JTrainer("t", _opt(), net_j, params=p_j, workspace=None,
                    use_checkpoint="scratch", mute=True)
    tr_t = TT.Trainer(_opt(), net_t, mute=True)
    out = []
    for step in range(n_steps):
        refresh = route == "O_ff" and tr_j.global_step % 16 == 0
        jitter, bg, perturb, draws = _jax_draws(route, tr_j.key, refresh)
        o, d, im = _batch(route, step)
        tr_j._maybe_refresh()
        tr_j.global_step += 1
        _, loss_j = tr_j.train_step({"rays_o": jnp.asarray(o),
                                     "rays_d": jnp.asarray(d),
                                     "images": jnp.asarray(im)})
        tr_t._maybe_refresh(jitter)
        tr_t.global_step += 1
        if route == "O_ff":
            tr_t.renderer_state = _state_t(tr_j.renderer_state)
        _, loss_t = tr_t.train_step(
            {"rays_o": _t(o), "rays_d": _t(d), "images": _t(im)},
            bg=bg, perturb=perturb, draws=draws)
        out.append((float(loss_j), float(loss_t),
                    [np.asarray(w) for w in TT.param_leaves(tr_j.params)],
                    [w.detach().numpy().copy() for w in net_t.param_list()]))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_trainer_steps_match_jax(route):
    """Four iterations of each route. A parameter whose gradient is near
    zero may move the other way under Adam (its first step is lr times the
    gradient's sign): 2 lr apart. Measured, float32 ("ff"): losses 6.5e-8
    relative; parameters 1.7e-6 apart at most. bfloat16 ("O_ff", the
    march handed JAX's refreshed state): losses 5.7e-4 relative; after the
    first update 0.39% of each tensor's entries more than 1e-6 apart, each
    by 2 lr; after the later ones the bf16 gradients' last bits move
    Adam's second moments, so most entries lie a little apart, and at most
    0.46% of each tensor's more than 2 lr (3.8e-2 at most). Bounds: losses
    1e-6 (float32) and 2e-3 (bfloat16) relative; float32 parameters 1e-5
    apart; bfloat16 after the first update 2% of the entries more than
    1e-6 apart, by 2 lr at most, and after every update at most 2% more
    than 2 lr apart (the mip-fold teacher's bounds, tests/
    test_torch_trainer.py)."""
    steps = _run_steps(route, 4)
    for i, (l_j, l_t, p_j, p_t) in enumerate(steps):
        if route == "ff":
            np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
            for a, b in zip(p_t, p_j):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            continue
        np.testing.assert_allclose(l_t, l_j, rtol=2e-3)
        for a, b in zip(p_t, p_j):
            err = np.abs(a - b)
            if i == 0:
                assert float(err.max()) <= 2 * LR * (1 + 1e-5)
                assert float((err > 1e-6).mean()) <= 0.02
            assert float((err > 2 * LR * (1 + 1e-5)).mean()) <= 0.02
    assert steps[-1][1] < steps[0][1]
