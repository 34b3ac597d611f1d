"""Training the fused mip-fold net, with and without `fold_warmup_scale`,
against the JAX trainer on the CPU.

The JAX net with fused=True trains through the Pallas kernel
`fused_sigma_color` (interpret mode on the CPU) and its `custom_vjp`; the
port's through K3's plain version under autograd (on the card: `_Chain`,
whose backward is the same VJP). With `fold_warmup_scale` the steps before
`grid_warmup_steps` train the same parameters through the net that folds
its dense levels at the reduced scale (JAX `Trainer._phase_net`, the
port's `NeRFNetworkMip.at_fold_scale`). Each test runs three iterations of
both trainers on the same batches with the JAX trainer's own draws handed
to the port, at tests/test_torch_trainer.py's small spec in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.train.trainer import Trainer as JTrainer
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.ops.hopper import sigma_color as K3
from nerfsafetyvalidation_tpu_torch.train import trainer as TT
from test_torch_trainer import (LR, NET, _batch, _jax_draws, _leaves_t,
                                _opt, _params)

torch.set_num_threads(1)

WARM = dict(grid_warmup_steps=2, fold_warmup_scale=8)


def _run(n_steps, **opt_kw):
    """n_steps iterations of the JAX trainer and the port's on the fused
    float32 net. Returns ([(loss_j, loss_t, params_j, params_t)] per step,
    the port's trainer, [whether each port step trained through the
    warm-up net])."""
    cfg = dict(NET, compute_dtype="float32", fused=True)
    net_j = j_make(JConfig(**cfg))
    p = _params(net_j)
    tr_j = JTrainer("t", _opt(**opt_kw), net_j,
                    params=jax.tree_util.tree_map(jnp.asarray, p),
                    workspace=None, use_checkpoint="scratch", mute=True)
    net_t = t_make(TConfig(**cfg), params_from_jax(p, device="cpu"),
                   device="cpu", trainable=True)
    tr_t = TT.Trainer(_opt(**opt_kw), net_t)
    out, warm = [], []
    for step in range(n_steps):
        jitter, bg, perturb = _jax_draws(tr_j.key,
                                         tr_j.global_step % 16 == 0)
        o, d, im = _batch(step)
        tr_j._maybe_refresh()
        tr_j.global_step += 1
        _, loss_j = tr_j.train_step({"rays_o": jnp.asarray(o),
                                     "rays_d": jnp.asarray(d),
                                     "images": jnp.asarray(im)})
        _, loss_t = tr_t.iteration(
            {"rays_o": torch.from_numpy(o), "rays_d": torch.from_numpy(d),
             "images": torch.from_numpy(im)}, bg=bg, perturb=perturb,
            jitter=jitter)
        warm.append(tr_t._step_net is not tr_t.net)
        out.append((float(loss_j), float(loss_t),
                    [np.asarray(w) for w in
                     jax.tree_util.tree_leaves(tr_j.params)],
                    [w.detach().numpy().copy() for w in _leaves_t(tr_t.net)]))
    return out, tr_t, warm


def _hold(steps):
    """tests/test_torch_trainer.py's float32 bounds: losses 1e-6 relative;
    parameters 1e-5 apart after two steps; after the third, lr / 2 at
    most and more than 0.1 lr on at most 0.1% of each tensor's entries
    (Adam divides each gradient by its own running size, so gradients
    near zero that differ in their last bits move further)."""
    for i, (l_j, l_t, p_j, p_t) in enumerate(steps):
        np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
        for a, b in zip(p_t, p_j):
            if i < 2:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            else:
                err = np.abs(a - b)
                assert float(err.max()) <= LR / 2
                assert float((err > 0.1 * LR).mean()) <= 1e-3


def test_fused_trainer_steps_match_jax():
    """Three iterations, the refresh included, through K3 forward and
    backward. Measured: losses 1.4e-7 relative at most; parameters 2.3e-6
    apart after two steps; after the third 0.32 lr at most, more than 0.1
    lr on 0.012% of the hash entries. Bounds: `_hold`'s."""
    calls = K3.PLAIN_CALLS
    steps, tr_t, warm = _run(3)
    assert K3.PLAIN_CALLS - calls == 3 and not any(warm)
    assert tr_t._net_warm is None
    _hold(steps)


def test_fold_warmup_steps_match_jax():
    """fold_warmup_scale 8 below the native fold scale 16 with
    grid_warmup_steps 2: the first iteration trains through the warm-up
    net (the same parameter tensors, folding at 8), the next two through
    the net itself, in both packages. The warm-up net's encoding differs
    from the native one's, so a trainer that ignored the scale would part
    from JAX's losses. Measured: losses 1.3e-7 relative at most;
    parameters 9.5e-7 apart after two steps; after the third 0.14 lr at
    most, more than 0.1 lr on 0.003% of the hash entries. Bounds:
    `_hold`'s."""
    steps, tr_t, warm = _run(3, **WARM)
    assert warm == [True, False, False]
    w = tr_t._net_warm
    assert w.mip_spec.F == 8 and tr_t.net.mip_spec.F == 16
    assert all(a is b for a, b in zip(w.param_list(), tr_t.net.param_list()))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (64, 3)).astype(np.float32))
    assert not torch.allclose(w.encode_pos(x), tr_t.net.encode_pos(x),
                              atol=1e-3)
    _hold(steps)


def test_fold_warmup_net_for_a_net_without_grid_ray():
    """Without cfg.grid_ray the JAX trainer builds its step once, with the
    net of the phase it is built in (trainer.py:134, :300-304), so a
    warm-up scale set at construction keeps the warm-up net; the port
    keeps the same. A net that is not mip-fold ignores the scale."""
    cfg = TConfig(**dict(NET, grid_ray=False, compute_dtype="float32"))
    net = t_make(cfg, None, device="cpu", trainable=True,
                 generator=torch.Generator().manual_seed(0))
    tr = TT.Trainer(_opt(**WARM), net)
    assert tr._step_net is not net and tr._step_net.mip_spec.F == 8
    tr.global_step = 5
    assert tr._phase_net() is net and tr._step_net is not net
    grid = t_make(TConfig(encoding="hashgrid", num_levels=2, level_dim=2,
                          log2_hashmap_size=8, base_resolution=4,
                          desired_resolution=8, bound=1.0), None,
                  device="cpu", trainable=True,
                  generator=torch.Generator().manual_seed(0))
    assert TT.Trainer(_opt(**WARM), grid)._step_net is grid
