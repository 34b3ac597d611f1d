"""The closed-loop batched engine of the port (nerfsafetyvalidation_tpu_torch/
validation/closed_loop.py) against the JAX package's on the CPU, at the
JAX package's own test sizes (tests/test_closed_loop.py: 16x16
observations, 24 interest pixels, T = 2 steps, n_iter 3 estimator
iterations, a 5-knot plan, 2 replan epochs), from the same weights and
disturbances:

  * `run` with the Gaussian `uq_engine`: the true and estimated states,
    the actions, the SDF values, the likelihoods, sigma_d and the reward;
  * `run` without it: the same states (the UQ changes no state), sigma_d
    and reward 0;
  * "frame" (the whole observation rendered, gathered at the pixels)
    equal to "pixels", and a run in groups of one sim equal to one run of
    the population;
  * the closed-loop CEM's 27-column CSV, and `_finite_risks`.

The net is a 2-level float32 hash-grid `NeRFNetwork` (numpy weights in the
JAX pytree's shapes, carried across with `params_from_jax`), unfused in
both packages: the closed-loop estimator differentiates the render twice,
which the JAX package cannot do through its fused kernel. JAX compiles one
engine (a module-scoped fixture)."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.models.network import NeRFNetwork as JNet
from nerfsafetyvalidation_tpu.nav.math_utils import \
    vec_to_rot_matrix as j_v2r
from nerfsafetyvalidation_tpu.validation import batched as JB
from nerfsafetyvalidation_tpu.validation import closed_loop as JCL
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.validation import batched as TB
from nerfsafetyvalidation_tpu_torch.validation import closed_loop as TCL

torch.set_num_threads(1)

RES = 16
T = 2
M = 2
NET = dict(num_levels=2, desired_resolution=32, bound=1.0)
INTR = (20.0, 20.0, RES / 2, RES / 2)
ROT = np.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                 np.float32)


def _setup():
    """Both nets, the plan's boundary states, knots and pixels."""
    net_j = JNet(JConfig(**NET))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] = rng.uniform(
        -1, 1, p["encoder"]["embeddings"].shape).astype(np.float32)
    net_t = make_network(TConfig(**NET), params_from_jax(p, device="cpu"),
                         device="cpu")
    zeros3 = np.zeros(3, np.float32)
    R0 = np.asarray(j_v2r(jnp.zeros(3))).reshape(-1)
    sp, ep = np.float32([-0.5, -0.5, 0.1]), np.float32([0.5, 0.5, 0.1])
    start12 = np.concatenate([sp, zeros3, zeros3, zeros3])
    end18 = np.concatenate([ep, zeros3, R0, zeros3]).astype(np.float32)
    slider = np.linspace(0.0, 1.0, 5, dtype=np.float32)[1:-1, None]
    knots = ((1 - slider) * np.append(sp, 0) + slider * np.append(ep, 0))
    coords = np.stack([rng.integers(0, RES, 24), rng.integers(0, RES, 24)],
                      axis=-1)
    body = np.stack(np.meshgrid(np.linspace(-0.05, 0.05, 4),
                                np.linspace(-0.05, 0.05, 4),
                                np.linspace(-0.02, 0.02, 2), indexing="ij"),
                    -1).reshape(-1, 3).astype(np.float32)
    noises = rng.normal(0.0, 0.01, (M, T, 12)).astype(np.float32)
    return dict(net_j=net_j, p_j=jax.tree_util.tree_map(jnp.asarray, p),
                net_t=net_t, start12=start12, end18=end18,
                knots=knots.astype(np.float32),
                ia=np.float32([10.0, 10.0]), coords=coords, body=body,
                noises=noises)


def _common(s):
    sdf = np.ones((96, 92, 24), np.float32)
    sdf[30:34] = 0.0                # a wall: no sim reaches it in 2 steps
    return dict(steps=T, dt=0.4, g=10.0, mass=1.0, I=np.eye(3), sdf=sdf,
                sdf_start=np.float32([-1.4, -1.3, -0.1]), granularity=40.0,
                noise_mean=np.zeros(12), noise_std=np.full(12, 0.01),
                start_state=s["start12"], fixed_coords=s["coords"],
                intrinsics=INTR, obs_hw=(RES, RES), n_iter=3, est_lr=1e-3,
                sig0=np.eye(12), Q=np.eye(12), filter=True,
                end_state=s["end18"], knots0=s["knots"],
                initial_accel0=s["ia"], epochs_update=2, planner_lr=1e-3,
                robot_body=s["body"])


def _uq_kw(s):
    return dict(dt=0.4, g=10.0, mass=1.0, I=np.eye(3, dtype=np.float32),
                sdf=np.ones((96, 92, 24), np.float32),
                sdf_start=[-1.4, -1.3, -0.1], granularity=40,
                noise_mean=np.zeros(12, np.float32),
                noise_std=np.full(12, 0.01, np.float32),
                start_state=s["start12"], obs_res=8, render_steps=8,
                base_res=RES, uq_method="gaussian", obs_render="uniform")


def _engine_t(s, uq=True, **kw):
    net = s["net_t"]
    rot = torch.from_numpy(ROT)

    def render(ro, rd):
        return TR.render(net, ro, rd, staged=False, bg_color=1.0,
                         num_steps=8, upsample_steps=0)

    def density(x):
        return 1e-3 * net.density(x.reshape(-1, 3) @ rot)["sigma"].reshape(
            x.shape[:-1])
    uq_engine = TB.FullBatchedRolloutEngine(
        np.zeros((T, 4), np.float32), net=net, device="cpu",
        **_uq_kw(s)) if uq else None
    return TCL.ClosedLoopBatchedEngine(
        render_rays_fn=render, density_fn=density, uq_engine=uq_engine,
        device="cpu", **dict(_common(s), **kw))


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's engine with the Gaussian UQ engine, one run of M sims."""
    s = setup
    net, p = s["net_j"], s["p_j"]
    rot = jnp.asarray(ROT)

    def render(ro, rd):
        return JR.render(net, p, ro, rd, staged=False, bg_color=1.0,
                         num_steps=8, upsample_steps=0)

    def density(x):
        return 1e-3 * net.density(p, x.reshape((-1, 3)) @ rot)[
            "sigma"].reshape(x.shape[:-1])
    uq = JB.FullBatchedRolloutEngine(
        actions=np.zeros((T, 4), np.float32), net=net, params=p,
        **_uq_kw(s))
    eng = JCL.ClosedLoopBatchedEngine(render_rays_fn=render,
                                      density_fn=density, uq_engine=uq,
                                      **_common(s))
    out = eng.run(jnp.asarray(s["noises"]))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port_run(setup):
    out = _engine_t(setup).run(setup["noises"])
    return {k: v.numpy() for k, v in out.items()}


# float32 on both sides; the same formulas summed in other orders, through
# 3 Adam steps of the estimator (lr-sized whatever the gradient), the
# inverse of the measurement's Hessian, 2 replan epochs a step, and the
# states that feed back into the next step's plan. Measured: states 9.5e-7
# (of ~2), actions 2.4e-6 (of 10), log-likelihoods 3.8e-6 (of 41), sigma_d
# 1.5e-6 (of 0.55), reward 5.5e-5 (of 24), positions and SDF values 0.
# Bounds (absolute) about 10x those; sigma_d and reward 1e-4 relative.
TOL = {"true_states": 1e-5, "est_states": 1e-5, "positions": 1e-5,
       "actions": 3e-5, "sdf_vals": 1e-5, "log_likelihoods": 4e-5}


def test_run_matches_jax(jax_run, port_run):
    """Every output of one run of M sims with the Gaussian UQ engine."""
    for k, tol in TOL.items():
        np.testing.assert_allclose(port_run[k], jax_run[k], rtol=0,
                                   atol=tol, err_msg=k)
    for k in ("sigma_d", "reward"):
        np.testing.assert_allclose(port_run[k], jax_run[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert (port_run["sigma_d"] > 0).all()
    assert np.isfinite(port_run["est_states"]).all()
    for k in ("collided", "ever_collided"):
        assert np.array_equal(port_run[k], jax_run[k])
    np.testing.assert_allclose(port_run["risk"], jax_run["risk"], atol=1e-5)
    moved = np.abs(port_run["est_states"] - port_run["true_states"]).max()
    assert 0 < moved < 0.1


def test_run_without_uq_engine(setup, port_run):
    """Without the UQ engine the states are the same bits; sigma_d and the
    reward are 0."""
    out = {k: v.numpy() for k, v in
           _engine_t(setup, uq=False).run(setup["noises"]).items()}
    for k in ("true_states", "est_states", "actions", "sdf_vals"):
        assert np.array_equal(out[k], port_run[k]), k
    assert not out["sigma_d"].any() and not out["reward"].any()


@pytest.mark.parametrize("kw", [{"obs_render": "frame"}, {"sim_group": 1}],
                            ids=["frame", "grouped"])
def test_frame_and_groups_equal_pixels(setup, port_run, kw):
    """The whole frame's target gathered at the pixels, or the sims run
    one at a time, give the states of one run of the population (the
    renders' rows are independent; bound 1e-6, measured 0)."""
    out = {k: v.numpy() for k, v in
           _engine_t(setup, **kw).run(setup["noises"]).items()}
    for k in ("true_states", "est_states", "sigma_d", "reward"):
        np.testing.assert_allclose(out[k], port_run[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_cem_csv_schema(setup, tmp_path):
    """Two closed-loop CEM iterations of 3 sims: 27 columns a row, steps
    0.. in order for each (iteration, sim), everCollided repeated; the
    proposal finite, its variances in (0, 0.1]."""
    eng = _engine_t(setup)
    path = tmp_path / "cem.csv"
    z = [np.random.default_rng(k).normal(size=(3, T, 12)).astype(np.float32)
         for k in range(2)]
    res = eng.cem(None, m=3, m_elite=2, kmax=2, csv_path=str(path), z=z)
    rows = list(csv.reader(open(path, newline="")))
    assert len(rows) == 2 * 3 * T
    assert all(len(r) == 27 for r in rows)
    assert [(int(r[0]), int(r[1]), int(r[2])) for r in rows] == [
        (k, i, t) for k in range(2) for i in range(3) for t in range(T)]
    assert all(r[25] == "False" and r[26] == "False" for r in rows)
    assert np.isfinite(res["means"]).all()
    assert ((res["vars"] > 0) & (res["vars"] <= 0.1)).all()
    assert len(res["history"]) == 2 and res["history"][0]["n_diverged"] == 0


def test_finite_risks_match_jax():
    risks = [0.5, np.nan, -np.inf, np.inf, 2.0]
    got = TCL._finite_risks(risks)
    assert np.array_equal(got, JCL._finite_risks(risks))
    assert np.array_equal(got, [0.5, np.inf, np.inf, np.inf, 2.0])


def test_state12_to_18_matches_jax():
    x = np.random.default_rng(1).normal(0, 0.3, (4, 12)).astype(np.float32)
    got = TCL.state12_to_18(torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(JCL.state12_to_18(jnp.asarray(r)))
                     for r in x])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
