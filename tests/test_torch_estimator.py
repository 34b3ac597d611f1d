"""The port's sequential estimator (nerfsafetyvalidation_tpu_torch/nav/
estimator.py) and one NerfSimulator.step against the JAX package's on the
CPU, from the same weights, plan settings and disturbance
(tests/torch_sequential_nets.py: a 2-level hash-grid net, a 16x16 camera,
16 samples a ray, a 64-pixel batch, 4 Adam steps; A*'s knots, 2 replan
epochs at a fixed horizon):

  * one `NerfSimulator.step` after `reset` (A*, the cached initial plan)
    in each package: collided, collisionVal, the position, sigma_d and
    mu_d, and the replanned knots;
  * that step's estimator: `find_POI` and the interest batch (the
    dilation and numpy's draw), with cv2 hidden from both packages so
    that both take the gradient detector and scipy's dilation (SIFT would
    make them disagree); the fit's states and losses, the Hessian and the
    posterior covariance, the saved JSON;
  * `measurement_fn`'s value and gradient in the state, and the
    dynamics' Jacobian against jax.jacfwd;
  * a featureless observation: both give up the same way.

JAX compiles its replan, its fit and its Hessian once (a module-scoped
fixture)."""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sequential_nets as S
from nerfsafetyvalidation_tpu.nav.agent import Agent as JAgent
from nerfsafetyvalidation_tpu.nav.camera import CannedCamera as JCanned
from nerfsafetyvalidation_tpu.nav import estimator as JE
from nerfsafetyvalidation_tpu.validation.simulators import \
    NerfSimulator as JSim
from nerfsafetyvalidation_tpu_torch.nav import estimator as TE
from nerfsafetyvalidation_tpu_torch.nav.agent import Agent as TAgent
from nerfsafetyvalidation_tpu_torch.nav.camera import CannedCamera as TCanned
from nerfsafetyvalidation_tpu_torch.utils.autodiff import jacobian_rows
from nerfsafetyvalidation_tpu_torch.validation.simulators import \
    NerfSimulator as TSim

torch.set_num_threads(1)

NOISE = np.float32([0.01, -0.02, 0.0, 0.01, 0, 0, 0, 0.01, 0, 0, 0, 0])


def _filter_cfg():
    return dict(S.FILTER, sig0=np.eye(12, dtype=np.float32),
                Q=np.eye(12, dtype=np.float32))


def _estimators(nets):
    net_j, p_j, net_t = nets
    agent_cfg = dict(S.AGENT, x0=S.START12)
    ja = JAgent(agent_cfg, S.CAMERA, camera=JCanned(res_x=S.RES,
                                                   res_y=S.RES))
    ta = TAgent(agent_cfg, S.CAMERA, camera=TCanned(res_x=S.RES,
                                                   res_y=S.RES),
                device="cpu")
    jf, tf = S.jax_fns(net_j, p_j), S.port_fns(net_t)
    je = JE.Estimator(_filter_cfg(), ja, S.START12,
                      get_rays_fn=jf["get_rays_fn"], render_fn=jf["render_fn"],
                      render_batch_fn=jf["render_batch_fn"])
    te = TE.Estimator(_filter_cfg(), ta, S.START12,
                      get_rays_fn=tf["get_rays_fn"], render_fn=tf["render_fn"],
                      render_batch_fn=tf["render_batch_fn"])
    return je, te


def _sim(pkg, nets):
    """The simulator of each package: start (-0.4, -0.4, 0.1) to goal
    (0.4, 0.4, 0.1), 2 epochs to plan and to replan at a fixed horizon,
    the wall SDF of x in [-0.4, -0.35) m (the start collides on its first
    step's interpolated states)."""
    net_j, p_j, net_t = nets
    zeros = np.zeros(3, np.float32)
    R0 = np.eye(3, dtype=np.float32).reshape(-1)
    start = np.concatenate([[-0.4, -0.4, 0.1], zeros, R0, zeros])
    end = np.concatenate([[0.4, 0.4, 0.1], zeros, R0, zeros])
    planner_cfg = {"T_final": 2.0, "steps": 8, "lr": 1e-3, "epochs_init": 2,
                   "epochs_update": 2, "fade_out_epoch": 0,
                   "fade_out_sharpness": 10, "fixed_horizon": True,
                   "start_state": start.astype(np.float32),
                   "end_state": end.astype(np.float32), "exp_name": "step",
                   "I": np.eye(3, dtype=np.float32), "g": 10.0, "mass": 1.0,
                   "body": np.asarray([[-0.05, 0.05], [-0.05, 0.05],
                                       [-0.02, 0.02]]), "nbins": [2, 2, 2]}
    sdf = np.ones((96, 92, 24), np.float32)
    sdf[40:42] = 0.0
    args = (start.astype(np.float32), end.astype(np.float32), S.AGENT,
            planner_cfg, S.CAMERA, _filter_cfg())
    blender = {"blend_path": None, "script_path": None}
    if pkg == "jax":
        f = S.jax_fns(net_j, p_j)
        return JSim(*args, f["get_rays_fn"], f["render_fn"], blender,
                    f["density_fn"], "Gaussian Approximation", net_j, p_j, 4,
                    camera=JCanned(res_x=S.RES, res_y=S.RES), sdf=sdf,
                    render_batch_fn=f["render_batch_fn"])
    f = S.port_fns(net_t)
    return TSim(*args, f["get_rays_fn"], f["render_fn"], blender,
                f["density_fn"], "Gaussian Approximation", net_t, 4,
                camera=TCanned(res_x=S.RES, res_y=S.RES), sdf=sdf,
                render_batch_fn=f["render_batch_fn"], device="cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """reset and one step with NOISE in each package, each in a working
    directory of its own, cv2 hidden."""
    nets = S.nets()
    out = {"nets": nets}
    old = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        for pkg in ("jax", "port"):
            os.chdir(tmp_path_factory.mktemp(pkg))
            try:
                # a cached initial plan: reset keeps A*'s knots and skips
                # learn_init (the cache's quirk, in both packages)
                for d in ("paths/step/init_poses", "cached/step/poses",
                          "cached/step/costs"):
                    os.makedirs(d)
                    Path(d, "0.json").write_text("{}")
                sim = _sim(pkg, nets)
                sim.reset()
                sig0 = np.asarray(sim.filter.sig)
                collided, val, pos, sigma, trace = sim.step(NOISE)
                est = sim.filter
                obs = np.round(np.asarray(est.target) * 255).astype(np.uint8)
                out[pkg] = dict(
                    collided=collided, val=float(val), pos=np.asarray(pos),
                    sigma=sigma, trace=trace, est=est, obs=obs,
                    knots=np.asarray(sim.traj.states),
                    true_state=np.asarray(sim.current_state),
                    xt=np.asarray(est.xt), sig=np.asarray(est.sig),
                    sig0=sig0, batch=np.asarray(est.batch),
                    losses=np.asarray(est.losses),
                    states=np.asarray(est.states),
                    json=json.loads(Path(sim.basefolder, "estimator_data",
                                         "step0.json").read_text()))
            finally:
                os.chdir(old)
        obs = out["jax"]["obs"]
        out["POI"] = {"jax": JE.find_POI(obs)[0], "port": TE.find_POI(obs)[0]}
        out["detector"] = TE.detector()
    out["true_state"] = out["port"]["true_state"]
    return out


def test_nerf_simulator_step_matches_jax(run):
    """The step's outputs: collided and collisionVal exactly, the position
    and the true state (the true dynamics, float32: measured equal, bound
    1e-6), the online UQ's mu_d and sigma_d (measured 3.1e-9 and 3.5e-7
    apart; bound 1e-4, see test_torch_uq_gaussian.py: the Gaussian MLE has
    no interior minimum, so sigma_d is where scipy stops, ~1e-5 here), the
    replanned knots (2 Adam epochs: measured 3.0e-8, bound 1e-5)."""
    j, t = run["jax"], run["port"]
    assert t["collided"] == j["collided"] and t["val"] == j["val"]
    np.testing.assert_allclose(t["pos"], j["pos"], rtol=1e-6)
    np.testing.assert_allclose(t["true_state"], j["true_state"], atol=1e-6)
    assert abs(t["trace"] - j["trace"]) <= 1e-4
    assert abs(t["sigma"] - j["sigma"]) <= 1e-4
    np.testing.assert_allclose(t["knots"], j["knots"], atol=1e-5)


def test_find_poi_and_batch_match_jax(run):
    """The step's 8-bit observations are the same; on it the gradient
    detector's points (as sets: both packages dedupe through a Python
    set), and the step's interest batch, exactly."""
    j, t = run["jax"], run["port"]
    np.testing.assert_array_equal(t["obs"], j["obs"])
    assert run["detector"] == "gradient"
    poi = run["POI"]
    assert len(poi["port"]) > 0
    assert set(map(tuple, poi["port"])) == set(map(tuple, poi["jax"]))
    assert t["batch"].shape == (S.FILTER["batch_size"], 2)
    np.testing.assert_array_equal(t["batch"], j["batch"])


def test_measurement_fn_value_and_grad(run):
    """At a state off the optimum: the loss and its gradient. float32,
    the same formulas summed in other orders (the render's compositing,
    the Mahalanobis product, the mean over 64 pixels): measured 1.3e-7
    relative on the loss, 1.6e-7 of the largest gradient component;
    bounds 1e-5 and 1e-5."""
    je, te = run["jax"]["est"], run["port"]["est"]
    state = (run["true_state"] + 0.01).astype(np.float32)
    sig = run["jax"]["sig0"]
    target = run["jax"]["obs"].astype(np.float32) / 255.0
    batch = run["jax"]["batch"]
    jl, jg = jax.jit(jax.value_and_grad(je.measurement_fn))(
        jnp.asarray(state), jnp.asarray(S.START12), jnp.asarray(sig),
        jnp.asarray(target), jnp.asarray(batch))
    leaf = torch.tensor(state, requires_grad=True)
    tl = te.measurement_fn(leaf, torch.from_numpy(S.START12),
                           torch.tensor(sig), torch.from_numpy(target),
                           torch.from_numpy(batch).long())
    tg, = torch.autograd.grad(tl, leaf)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(tg.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def test_jacobian_matches_jacfwd(run):
    """The dynamics' 12x12 Jacobian at the propagated state: 12 backward
    rows against jax.jacfwd; float32, the same chain: measured 1.2e-7,
    bound 1e-5."""
    ja, ta = run["jax"]["est"].agent, run["port"]["est"].agent
    x = run["jax"]["json"]["state_estimate"]
    A_j = jax.jacfwd(lambda s: ja.drone_dynamics(s, jnp.asarray(S.HOVER)))(
        jnp.asarray(x, dtype=jnp.float32))
    A_t = jacobian_rows(lambda s: ta.drone_dynamics(s, S.HOVER),
                        torch.tensor(x, dtype=torch.float32))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), atol=1e-5)


def test_fit_matches_jax(run):
    """The fit's states after N_iter Adam steps and its losses. Adam moves
    each entry by about lr a step whatever the gradient's size, so the
    states agree to float32 rounding of the propagated state: measured
    1.5e-8, bound 1e-5; the losses 1.4e-6 relative, bound 1e-5. The fit
    lands within 0.1 of the true state (0.016 here)."""
    j, t = run["jax"], run["port"]
    np.testing.assert_allclose(t["states"], j["states"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["xt"], j["xt"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)
    assert len(t["losses"]) == S.FILTER["N_iter"]
    assert np.abs(t["xt"] - run["true_state"]).max() < 0.1


def test_posterior_covariance_matches_jax(run):
    """The Hessian of the measurement at the optimum (12 double-backward
    rows against jax.hessian) and its inverse, the posterior covariance.
    Second derivatives of the float32 render: measured 5.0e-7 of the
    Hessian's largest entry and 1.3e-7 of the covariance's; bounds 1e-4
    of each (the double backward sums in other orders than JAX's forward-
    over-reverse)."""
    j, t = run["jax"], run["port"]
    H_j, H_t = np.linalg.inv(j["sig"]), np.linalg.inv(t["sig"])
    assert np.abs(H_t - H_j).max() <= 1e-4 * np.abs(H_j).max()
    assert np.abs(t["sig"] - j["sig"]).max() <= 1e-4 * np.abs(j["sig"]).max()
    assert np.isfinite(t["sig"]).all()
    assert not np.allclose(t["sig"], t["sig0"])


def test_saved_json_matches_jax(run):
    """estimator_data/step0.json: the same keys, the action exactly, the
    numbers at the tolerances above."""
    j, t = run["jax"]["json"], run["port"]["json"]
    assert set(t) == set(j) == {"loss", "covariance", "state_estimate",
                                "grad_states", "action"}
    assert t["action"] == j["action"]
    np.testing.assert_allclose(t["state_estimate"], j["state_estimate"],
                               atol=1e-5)
    np.testing.assert_allclose(t["grad_states"], j["grad_states"], atol=1e-5)
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
    cj = np.asarray(j["covariance"])
    assert np.abs(np.asarray(t["covariance"]) - cj).max() <= \
        1e-4 * np.abs(cj).max()


def test_featureless_observation(run, monkeypatch, capsys):
    """A uniform image has no interest points: both packages print the
    failure, return the propagated state unfitted and keep the prior
    covariance."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    je, te = _estimators(run["nets"])
    flat = np.full((S.RES, S.RES, 3), 128, np.uint8)
    xj = np.asarray(je.estimate_state(flat, None, S.HOVER))
    xt = te.estimate_state(flat, None, S.HOVER).numpy()
    assert capsys.readouterr().out.count("Feature Detection Failed") == 2
    np.testing.assert_allclose(xt, xj, atol=1e-6)
    np.testing.assert_array_equal(te.sig.numpy(), np.asarray(je.sig))
    assert te.losses == je.losses == []
