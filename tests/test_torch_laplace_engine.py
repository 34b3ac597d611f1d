"""The in-scan Laplace UQ of the port's batched rollouts (nerfsafety
validation_tpu_torch/validation/batched.py, uq_method="laplace") and the
grouped mode of kernel K4 that it runs (ops/hopper/fused_mlp.py
`fused_mlp_grouped`), against the JAX package's on the CPU.

  * grouped K4: its plain version against `jax.vmap(fused_mlp)` (one
    weight set per group, the Pallas kernel in interpret mode), values and
    gradients;
  * the engine's MAP fits against the JAX package's BayesianLaplace on the
    same points and draws;
  * the engine's Levenberg-Marquardt steps against the JAX engine's
    (`lm_body` of its `_laplace_uq`) from the same thetas: the iterate, g,
    lmbda and the stop flags;
  * a whole Monte Carlo run with the Laplace UQ on a tiny `--ff` net (3
    sims, 2 steps, 8^2 observations, 16 points, 5 Adam steps, 3 LM
    steps), JAX's disturbances and Laplace draws handed in: each (sim,
    step)'s trace, rmv and reward."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sequential_nets as S
from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.ops.pallas.fused_mlp import \
    fused_mlp as j_fused_mlp
from nerfsafetyvalidation_tpu.uq import hessian as JH
from nerfsafetyvalidation_tpu.uq.bayesian_laplace import \
    BayesianLaplace as JBL
from nerfsafetyvalidation_tpu.validation import batched as JB
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as K4
from nerfsafetyvalidation_tpu_torch.validation import batched as TB

torch.set_num_threads(1)

FF = types.SimpleNamespace(ff=True, tcnn=False)
NET_FF = dict(encoding="hashgrid", bound=1.0, num_levels=4, level_dim=2,
              base_resolution=4, log2_hashmap_size=10, desired_resolution=32,
              hidden_dim=16, hidden_dim_color=16, fused=True, grid_size=16,
              compute_dtype="float32")


# --------------------------------------------------------------- grouped K4
def _grouped_case(G=3, N=40, widths=(32, 64, 64, 16), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, N, widths[0])).astype(np.float32)
    ws = [(rng.normal(size=(G, a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(widths, widths[1:])]
    return x, ws


def _vmapped(x, ws):
    return jax.vmap(lambda xg, *wg: j_fused_mlp(xg, list(wg),
                                                jnp.bfloat16))(x, *ws)


@pytest.mark.parametrize("shape", [(3, 40, (32, 64, 64, 16)),
                                   (5, 17, (24, 48, 8))],
                         ids=["ff_sigma", "ragged"])
def test_grouped_plain_matches_vmapped_jax(shape):
    """Values: every layer rounded to bf16 on both sides, f32 sums in other
    orders; bounded at one bf16 step (2^-8) of max(|out|, 1) (test_torch_
    fused_mlp.py's K4 bound)."""
    G, N, widths = shape
    x, ws = _grouped_case(G, N, widths)
    want = np.asarray(_vmapped(jnp.asarray(x), [jnp.asarray(w) for w in ws]))
    before = K4.PLAIN_CALLS_GROUPED
    got = K4.fused_mlp_grouped(torch.from_numpy(x),
                               [torch.from_numpy(w) for w in ws])
    assert K4.PLAIN_CALLS_GROUPED == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -8,
                               atol=2.0 ** -8)


def test_grouped_gradients_match_jax_vjp():
    """d(sum(c * out)) / d(x, each weight set) against jax.vjp of the
    vmapped kernel (its custom VJP: the XLA chain recomputed); within 1e-2
    of each tensor's largest gradient (the bound of K4's bf16 gradients,
    test_torch_k4_grad.py)."""
    x, ws = _grouped_case()
    c = np.random.default_rng(1).normal(size=(3, 40, 16)).astype(np.float32)
    _, vjp = jax.vjp(_vmapped, jnp.asarray(x), [jnp.asarray(w) for w in ws])
    gx_j, gws_j = vjp(jnp.asarray(c))
    xt = torch.from_numpy(x).requires_grad_(True)
    wts = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    out = K4.fused_mlp_grouped(xt, wts)
    got = torch.autograd.grad((out * torch.from_numpy(c)).sum(), [xt, *wts])
    for g, w in zip(got, [gx_j, *gws_j]):
        w = np.asarray(w)
        gap = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        assert gap <= 1e-2, gap


def test_grouped_rejects_unlinked_weights():
    x, ws = _grouped_case()
    bad = [torch.from_numpy(w) for w in ws]
    bad[1] = bad[1][:2]
    with pytest.raises(ValueError, match="one G"):
        K4._grouped_widths(bad)


# --------------------------------------------------------------- the engine
def _ff_nets(seed=3):
    net_j = j_make(JConfig(**NET_FF), FF)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.5, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] *= 0.1
    net_t = t_make(TConfig(**NET_FF), params_from_jax(p, device="cpu"),
                   device="cpu", opt=FF)
    return net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


@pytest.fixture(scope="module")
def ff_nets():
    return _ff_nets()


RES, STEPS, M = 8, 2, 3
LAPLACE = dict(uq_method="laplace", laplace_points=16, laplace_fit_steps=5,
               laplace_lm_iters=3)


def _engine_kw():
    """A camera 2 m out on -x looking along +x at the field (the
    sequential tests' POSE), free space everywhere."""
    start = TB.start_state_from_pose(np.float32(
        [[0, 0, 1, -2.0], [1, 0, 0, 0.0], [0, 1, 0, 0.0], [0, 0, 0, 1]]))
    return dict(actions=np.tile(np.float32([10.0, 0.0, 0.0, 0.0]),
                                (STEPS, 1)),
                dt=0.1, g=10.0, mass=1.0, I=np.eye(3, dtype=np.float32),
                sdf=np.ones((8, 8, 8), np.float32),
                sdf_start=[-4.0, -4.0, -4.0], granularity=1,
                noise_mean=np.zeros(12, np.float32),
                noise_std=np.full(12, 0.02, np.float32), start_state=start,
                obs_res=RES, render_steps=8, base_res=RES,
                base_intrinsics=(10.0, 10.0, RES / 2, RES / 2))


def _jax_laplace_draws(n_theta, uq_key=jax.random.PRNGKey(0)):
    """JAX's draws per step: sim i's key fold_in(fold_in(uq_key, t), i),
    split into theta's init [n] and the perturbations [3, 16, 3]."""
    out = []
    for t in range(STEPS):
        key_t = jax.random.fold_in(uq_key, t)
        th, pe = [], []
        for i in range(M):
            k_init, k_pert = jax.random.split(jax.random.fold_in(key_t, i))
            th.append(np.array(jax.random.normal(k_init, (n_theta,))))
            pe.append(np.array(jax.random.normal(k_pert, (3, 16, 3))))
        out.append((np.stack(th), np.stack(pe)))
    return out


@pytest.mark.parametrize("which", ["f32", "ff"])
def test_engine_map_fit_matches_jax_bayesian_laplace(which, ff_nets,
                                                     monkeypatch):
    """The engine's MAP fits of 2 sims at once (each 3 copies of its own
    16 points, 10 Adam steps of lr 1e-2) against the JAX package's
    BayesianLaplace on each sim's points, data and draws (seeds 0 and 1;
    its posterior mean, before its LM): float32 net within 1e-5; the FF
    net at the bf16 bound of test_torch_uq_laplace.py's fit (2 lr a step
    at most, 85% of the entries within 1e-4)."""
    net_j, p_j, net_t = S.nets() if which == "f32" else ff_nets
    rng = np.random.default_rng(7)
    X = rng.uniform(-0.8, 0.8, (2, 16, 3)).astype(np.float32)
    y = rng.uniform(0, 2, (2, 16)).astype(np.float32)
    n = net_t.get_sigma_net_flat().shape[0]
    # the JAX fit's LM stage, which the mean does not read, cut to a step
    monkeypatch.setattr(JH, "levenberg_marquardt", functools.partial(
        JH.levenberg_marquardt, max_iter=1))
    theta0, perts, want = [], [], []
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        key, s1 = jax.random.split(key)
        key, s2 = jax.random.split(key)
        theta0.append(np.array(jax.random.normal(s1, (n,))))
        perts.append(np.array(jax.random.normal(s2, (3, 16, 3))))
        want.append(np.asarray(JBL(net_j, p_j, 0.0, 1.0, 1e-2, fit_steps=10,
                                   seed=seed).fit(X[seed], y[seed])
                               .posterior_mean))
    eng = TB.FullBatchedRolloutEngine(net=net_t, device="cpu", **{
        **_engine_kw(), **LAPLACE, "laplace_fit_steps": 10})
    got = eng._laplace_map(*map(torch.from_numpy, (
        X, y, np.stack(theta0), np.stack(perts)))).numpy()
    gap = np.abs(got - np.stack(want))
    if which == "f32":
        assert gap.max() <= 1e-5, gap.max()
    else:
        assert gap.max() <= 0.2 and (gap <= 1e-4).mean(axis=1).min() \
            >= 0.85, (gap.max(), (gap <= 1e-4).mean(axis=1))


def _jax_lm(net_j, p_j, x, X, y, iters, prior_std=1.0):
    """The JAX engine's in-scan LM (nerfsafetyvalidation_tpu/validation/
    batched.py, `_laplace_uq`'s `nlp` and `lm_body`, there a closure)
    vmapped over the sims, from x [m, n] on X [m, P, 3], y [m, P] ->
    (x, g, lmbda, done), the last two of its carry kept."""
    prior_var = prior_std ** 2

    def nlp(theta, X_p, y_p):
        p = net_j.set_sigma_net_flat(p_j, theta)
        y_pred = net_j.density(p, X_p)["sigma"]
        log_prior = -0.5 * jnp.sum(theta ** 2) / prior_var
        log_lik = -0.5 * jnp.sum((y_p - y_pred) ** 2)
        return -(log_prior + log_lik)

    def one(x0, X_p, y_p):
        grad_fn = jax.grad(nlp)
        f_x0 = nlp(x0, X_p, y_p)

        def lm_body(i, carry):
            x, lmbda, g_last, done = carry
            g = grad_fn(x, X_p, y_p)
            g_last = jnp.where(done, g_last, g)
            dx = -g / (lmbda + jnp.sum(g ** 2))
            converged = jnp.all(jnp.abs(dx) < 1e-12)
            x_new = x + dx
            improved = nlp(x_new, X_p, y_p) < f_x0
            lmbda_new = jnp.where(improved, lmbda / 10.0, lmbda * 10.0)
            keep = done | converged
            return (jnp.where(keep, x, x_new),
                    jnp.where(keep, lmbda, lmbda_new), g_last, keep)

        return jax.lax.fori_loop(
            0, iters, lm_body, (x0, jnp.asarray(0.01), jnp.zeros_like(x0),
                                jnp.asarray(False)))

    x, lmbda, g, done = jax.jit(jax.vmap(one))(x, X, y)
    return tuple(map(np.asarray, (x, g, lmbda, done)))


# the LM's starts: thetas of these scales (a random start, then ones that
# overshoot at first, so that lmbda rises and falls and some sims stop)
LM_STARTS = dict(f32=(1.0, 0.3, 0.03, 0.02), ff=(1.0, 0.3, 0.05, 0.03, 0.02))


@pytest.mark.parametrize("which", ["f32", "ff"])
def test_engine_lm_matches_jax(which, ff_nets):
    """The engine's `_laplace_lm` (20 steps, 16 points a sim) against the
    JAX engine's from the same thetas, points and densities. lmbda moves
    by factors of ten on each `f(x + dx) < f(x0)` and a sim stops once
    every |dx| < 1e-12, so lmbda and the stop flags are held exactly:
    they pin every decision (a flipped sign of dx, a swapped lmbda rule,
    comparing with the last iterate instead of f(x0), or another stop
    rule each change them). Of the start scales tried (1 to 1e-4), 0.1
    and (on the float32 net) 0.05 put one f(x + dx) within rounding of
    f(x0), where any two implementations part, so LM_STARTS leaves them
    out. The iterate x and g, relative to their largest entry: a start
    that overshoots (dx ~ -g / lmbda while |g|^2 < lmbda) moves x far
    into a steep part of the loss, which magnifies rounding, so float32
    net within 1e-2 (measured 1.7e-3); FF net (bf16 sigma net) x within
    5e-2, g's norm within 5e-2 and its worst entry within 0.25 (measured
    2.1e-2, 2.9e-2 and 0.12)."""
    net_j, p_j, net_t = S.nets() if which == "f32" else ff_nets
    rng = np.random.default_rng(11)
    scales = np.asarray(LM_STARTS[which])
    m = scales.size
    X = rng.uniform(-0.8, 0.8, (m, 16, 3)).astype(np.float32)
    y = rng.uniform(0, 2, (m, 16)).astype(np.float32)
    n = net_t.get_sigma_net_flat().shape[0]
    x0 = (rng.normal(0, 1, (m, n)) * scales[:, None]).astype(np.float32)
    eng = TB.FullBatchedRolloutEngine(net=net_t, device="cpu", **{
        **_engine_kw(), **LAPLACE, "laplace_lm_iters": 20})
    got = [t.numpy() for t in eng._laplace_lm(
        torch.from_numpy(x0), torch.from_numpy(X), torch.from_numpy(y))]
    want = _jax_lm(net_j, p_j, x0, X, y, 20)
    assert want[3].any() and not want[3].all()
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)

    def rel(a, b):
        return np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)
    x_rel, g_rel = rel(got[0], want[0]), rel(got[1], want[1])
    norm = np.linalg.norm
    g_norm = np.abs(norm(got[1], axis=1) / norm(want[1], axis=1) - 1)
    if which == "f32":
        assert x_rel.max() <= 1e-2 and g_rel.max() <= 1e-2, (x_rel, g_rel)
    else:
        assert x_rel.max() <= 5e-2 and g_norm.max() <= 5e-2 \
            and g_rel.max() <= 0.25, (x_rel, g_norm, g_rel)


def test_monte_carlo_with_laplace_matches_jax(ff_nets):
    """A Monte Carlo run on the FF net with the Laplace UQ, JAX's
    disturbances and per-(sim, step) draws handed in. The trace (the JAX
    engine does not return it: there it is (rmv n)^2, exact in real
    arithmetic) and rmv depend on the fits only through g's share of
    (g g^T + 1e-2 I)^-1, so they agree far inside the bf16 fits' spread:
    rmv and trace within 1e-5 relative, the reward within 1e-4 absolute
    (36 x 3 x rmv x trace, and the disturbances' log-likelihood at float32
    rounding), the positions within 1e-6."""
    net_j, p_j, net_t = ff_nets
    kw = dict(_engine_kw(), **LAPLACE)
    ej = JB.FullBatchedRolloutEngine(net=net_j, params=p_j, **kw)
    et = TB.FullBatchedRolloutEngine(net=net_t, device="cpu", **kw)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (M, STEPS, 12)))
    want = {k: np.asarray(v) for k, v in ej.run(jnp.asarray(z)).items()}
    n = net_t.get_sigma_net_flat().shape[0]
    launches = K4.PLAIN_CALLS_GROUPED
    got = {k: v.numpy() for k, v in et.run(
        z, laplace_draws=_jax_laplace_draws(n)).items()}
    assert K4.PLAIN_CALLS_GROUPED > launches      # the fits went grouped
    assert got["trace"].shape == got["sigma_d"].shape == (M, STEPS)
    np.testing.assert_allclose(got["positions"], want["positions"],
                               atol=1e-6)
    np.testing.assert_allclose(got["sigma_d"], want["sigma_d"], rtol=1e-5)
    np.testing.assert_allclose(got["trace"], (want["sigma_d"] * n) ** 2,
                               rtol=1e-5)
    np.testing.assert_allclose(got["reward"], want["reward"], atol=1e-4)
    np.testing.assert_allclose(got["reward_prev"], want["reward_prev"],
                               atol=1e-4)
    assert np.isfinite(got["reward"]).all()



# ------------------------------------------------------- the validate CLI
def _laplace_workdir(root, sims):
    """test_torch_validate.py's toy working directory with envConfig's
    uq_method the Bayesian Laplace approximation."""
    import json
    from pathlib import Path

    from test_torch_validate import _workdir
    _workdir(root, sims=sims)
    env = json.loads(Path("envConfig.json").read_text())
    env["uq_method"] = "Bayesian Laplace Approximation"
    Path("envConfig.json").write_text(json.dumps(env))


@pytest.fixture
def cwd(tmp_path):
    import os
    old = os.getcwd()
    yield tmp_path
    os.chdir(old)


@pytest.mark.parametrize("closed_loop", [False, True],
                         ids=["batched", "closed_loop"])
def test_validate_runs_the_laplace_uq(closed_loop, cwd, capsys):
    """validate --batched_rollouts (and --closed_loop, its UQ `auto`) with
    envConfig's Laplace: the JAX CLI's [INFO] lines and the in-scan
    Laplace fits' rmv, > 0 where finite. Not every sim's is: the fits
    start from a random normal theta (bayesian_laplace.py:58), and on this
    frequency net one sim's start puts sigma near float32's top, its
    gradient overflows, Adam's update is NaN, and in Monte Carlo the NaN
    reward then scales the next disturbance, so that sim stays NaN; the
    JAX package computes the same (ROADMAP Queue 3). The arithmetic itself
    is held to JAX's by test_monte_carlo_with_laplace_matches_jax."""
    import random

    from nerfsafetyvalidation_tpu_torch import validate as V
    from test_torch_validate import BASE
    _laplace_workdir(cwd, sims=2)
    random.seed(0)
    res = V.main(BASE + (["--closed_loop"] if closed_loop else []),
                 device="cpu")
    out = capsys.readouterr().out
    assert "[INFO] batched rollouts with in-scan Bayesian-Laplace UQ" in out
    if closed_loop:
        assert "[INFO] closed-loop steps compute the laplace" in out
    rmv = res["sigma_d"]
    ok = np.isfinite(rmv)
    assert ok.any() and (rmv[ok] > 0).all()
    assert (np.isfinite(res["reward"]) == ok).all()
