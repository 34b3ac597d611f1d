"""The port's sequential stress tests and entry points
(nerfsafetyvalidation_tpu_torch/validation/{stresstests,simulators}/,
validate.py without --batched_rollouts, simulate.py) on the CPU:

  * Monte Carlo and the cross-entropy method on `ToySimulator`, the JAX
    package's threefry draws handed to the port as standard normals: the
    CSV rows (and CEM's proposals) against the JAX package's;
  * end to end on the port only: `validate.main` (sequential Monte Carlo
    and cross-entropy) and `simulate.main` on a toy working directory
    (tests/test_torch_validate.py's `_workdir`, on a fixed start and goal
    whose plan has more knots than the run has steps), with device='cpu';
    the cross-entropy method resumed at its last iteration with `--k`;
  * `simulate --ff` refused before anything loads; `simulate --tcnn` and
    sequential `validate --tcnn` run."""

import csv
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.validation.distributions import \
    SeedableMultivariateNormal as JMVN
from nerfsafetyvalidation_tpu.validation.simulators import \
    ToySimulator as JToy
from nerfsafetyvalidation_tpu.validation.stresstests import (
    CrossEntropyMethod as JCEM, MonteCarlo as JMC)
from nerfsafetyvalidation_tpu_torch import simulate as TSimulate
from nerfsafetyvalidation_tpu_torch import validate as V
from nerfsafetyvalidation_tpu_torch.nav.planner import Planner as TPlanner
from nerfsafetyvalidation_tpu_torch.validation.distributions import \
    SeedableMultivariateNormal as TMVN
from nerfsafetyvalidation_tpu_torch.validation.simulators import \
    ToySimulator as TToy
from nerfsafetyvalidation_tpu_torch.validation.stresstests import (
    CrossEntropyMethod as TCEM, MonteCarlo as TMC)
from test_torch_validate import BASE, _workdir

torch.set_num_threads(1)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_rows(got, want, rtol):
    """Row by row: integers and booleans exactly, numbers at rtol (and
    1e-6 absolute)."""
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if b in ("True", "False") or b.lstrip("-").isdigit():
                assert a == b, (g, w)
            else:
                assert abs(float(a) - float(b)) <= 1e-6 + rtol * abs(
                    float(b)), (g, w)


# ------------------------------------------------------ toy stress tests
def test_monte_carlo_toy_matches_jax(tmp_path, monkeypatch):
    """4 sims of 8 steps (a collision threshold of 0.15 m: some collide),
    JAX's key chain (one split a step, across the sims) handed in. The
    noise, positions and likelihoods are the same float32 operations:
    bound 1e-6 relative; the collisions exactly."""
    mean, std = np.zeros(2, np.float32), np.full(2, 0.05, np.float32)
    monkeypatch.chdir(tmp_path)
    os.makedirs("jax")
    os.chdir("jax")
    JMC(JToy(0.15), 4, 8, mean, std, None, None, 0, noise_seed=5).validate()
    key, z = jax.random.PRNGKey(5), []
    for _ in range(4 * 8):
        key, sub = jax.random.split(key)
        z.append(np.asarray(jax.random.normal(sub, (2,))))
    os.chdir(tmp_path)
    TMC(TToy(0.15), 4, 8, mean, std, None, None, 0, noise_seed=5,
        normals=z).validate()
    name = "results/collisionValuesBlenderMC_n4.csv"
    got, want = _rows(name), _rows(f"jax/{name}")
    _same_rows(got, want, 1e-6)
    assert all(len(r) == 11 for r in got)
    hits = [r for r in got if r[-2] == "True"]
    assert hits and sorted(os.listdir("results/failures")) == sorted(
        os.listdir("jax/results/failures"))
    # the port's own draws: a seeded generator, reproducible
    os.remove(name)
    TMC(TToy(0.15), 4, 8, mean, std, None, None, 0,
        noise_seed=5).validate()
    first = _rows(name)
    os.remove(name)
    TMC(TToy(0.15), 4, 8, mean, std, None, None, 0,
        noise_seed=5).validate()
    assert _rows(name) == first


def _cem(pkg, toy, normals=None, best=None):
    steps, m, m_elite, kmax = 6, 6, 3, 3
    means = [np.zeros(2, np.float32)] * steps
    covs = [np.eye(2, dtype=np.float32) * 0.25] * steps
    MVN, Toy, CEM = (JMVN, JToy, JCEM) if pkg == "jax" else \
        (TMVN, TToy, TCEM)
    kw = {} if pkg == "jax" else dict(normals=normals, best_normals=best)
    cem = CEM(Toy(4.0), MVN(means, covs, noise_seed=0),
              MVN(means, covs, noise_seed=0), m=m, m_elite=m_elite,
              kmax=kmax, noise_seed=0, blend_file=None, workspace=None, **kw)
    cem.TOY_PROBLEM = toy
    return cem.optimize()


@pytest.mark.parametrize("toy", [False, True], ids=["risk", "toy_problem"])
def test_cross_entropy_toy_matches_jax(toy, tmp_path, monkeypatch):
    """3 iterations of 6 sims (3 elite) of 6 steps, JAX's draws handed in
    (split of fold_in(PRNGKey(0), sim); the best solution's chain of
    fold_in(base, 2^30)). TOY_PROBLEM takes the elites from the top. The
    CSV (written without TOY_PROBLEM): 14 columns, the log-densities are
    float32 Cholesky solves in other orders (bound 1e-5 relative); the
    proposals' means and covariances (float64 from those) 1e-4."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("jax")
    os.chdir("jax")
    want = _cem("jax", toy)
    os.chdir(tmp_path)

    def normals(k, sim):
        keys = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(0), sim), 6)
        return np.stack([np.asarray(jax.random.normal(kk, (2,)))
                         for kk in keys])
    key, best = jax.random.fold_in(jax.random.PRNGKey(0), 2 ** 30), []
    for _ in range(6):
        key, sub = jax.random.split(key)
        best.append(np.asarray(jax.random.normal(sub, (2,))))
    got = _cem("port", toy, normals, np.stack(best))
    for i in (0, 1):
        np.testing.assert_allclose(np.asarray(got[i]), np.asarray(want[i]),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5)
    name = "results/collisionValuesCEM_m6melite3k3.csv"
    if toy:
        assert not os.path.exists(name)
        return
    rows = _rows(name)
    assert all(len(r) == 14 for r in rows)
    _same_rows(rows, _rows(f"jax/{name}"), 1e-5)


# ---------------------------------------------------------- end to end
SEQ = [a for a in BASE if a != "--batched_rollouts"] + ["--camera", "nerf"]
# a start and goal 0.42 m apart, 5 steps: A*'s path has 7 knots (the
# planner drops one a step and needs one left)
PATH = ([-0.4, -0.2, 0.15], [-0.1, 0.1, 0.15], 5)


def _seq_workdir(root, stress="Monte Carlo", sims=2):
    """_workdir's directory with the estimator's batch cut to 64 pixels."""
    _workdir(root, stress=stress, sims=sims)
    env = json.loads(Path("envConfig.json").read_text())
    env["estimator_cfg"]["batch_size"] = 64
    Path("envConfig.json").write_text(json.dumps(env))


@pytest.fixture
def seq_dir(tmp_path, monkeypatch):
    old = os.getcwd()
    monkeypatch.setattr(V, "generate_path", lambda *ranges: PATH)
    yield tmp_path
    os.chdir(old)


def test_validate_sequential_monte_carlo(seq_dir, capsys):
    """validate without --batched_rollouts: MonteCarlo over NerfSimulator
    .step, the reference MC CSV (24 columns with the reward and sigma_d)
    appended a simulation at a time, the estimator's JSON a step."""
    _seq_workdir(seq_dir)
    V.main(SEQ, device="cpu")
    out = capsys.readouterr().out
    assert "Starting Monte Carlo test with 2 simulations" in out
    assert ".End of validation.." in out
    rows = _rows("results/collisionValuesBlenderMC_n2.csv")
    steps = PATH[2]
    assert {int(r[0]) for r in rows} == {0, 1}
    assert all(len(r) == 24 for r in rows)
    for i in (0, 1):
        mine = [r for r in rows if int(r[0]) == i]
        hit = [r[-2] == "True" for r in mine]
        assert not any(hit[:-1]) and (hit[-1] or len(mine) == steps)
        assert all(np.isfinite(float(v)) for v in mine[-1][2:-2])
    assert len(os.listdir("paths/ws/estimator_data")) >= 1


def test_validate_sequential_cross_entropy(seq_dir, capsys):
    """The sequential CEM as the JAX CLI runs it (10 sims, 5 elite, 5
    iterations), resumed with --iter 8 --k 4 at its last iteration's last
    two sims on the saved path: their rows of the 27-column CSV, and the
    best solution printed."""
    _seq_workdir(seq_dir, stress="Cross Entropy Method")
    V.save_coords(*PATH)
    res = V.main(SEQ + ["--iter", "8", "--k", "4"], device="cpu")
    out = capsys.readouterr().out
    assert "Starting population 4" in out and "Best objective value" in out
    rows = _rows("results/collisionValuesCEM_m10melite5k5.csv")
    assert all(len(r) == 27 for r in rows)
    assert {(int(r[0]), int(r[1])) for r in rows} == {(4, 8), (4, 9)}
    assert len(res[0]) == PATH[2] and np.isfinite(res[5])


def test_simulate_main(seq_dir, capsys):
    """simulate: A* and learn_init from envConfig's start to its goal,
    then one step an action of the plan (replans but for the last 5),
    with the NeRF camera; finite true states, one estimator JSON a
    step."""
    _seq_workdir(seq_dir)
    argv = ["data", "--workspace", "ws", "--bound", "1", "--scale", "1",
            "--seed", "3", "--num_steps", "8", "--encoding", "frequency",
            "--camera", "nerf"]
    states = TSimulate.main(argv, device="cpu")
    assert states.shape[1] == 12 and states.shape[0] > 6
    assert np.isfinite(states).all()
    np.testing.assert_allclose(states[0, :3], [-0.75, -0.235, 0.25],
                               atol=1e-6)
    assert len(os.listdir("paths/ws/estimator_data")) == states.shape[0] - 1
    assert len(os.listdir("paths/ws/replan_poses")) == states.shape[0] - 6


def test_simulate_main_short_plan(seq_dir, monkeypatch):
    """A plan of 4 knots (A*'s thinned, first and last kept) flies its 7
    actions: the first 2 steps with a replan, the last 5 on the plan
    without one."""
    _seq_workdir(seq_dir)
    astar = TPlanner.a_star_init

    def thinned(self, *a, **k):
        astar(self, *a, **k)
        keep = np.unique(np.linspace(0, self.states.shape[0] - 1, 4)
                         .round().astype(np.int64))
        self.states = self.states[torch.as_tensor(keep)]

    monkeypatch.setattr(TPlanner, "a_star_init", thinned)
    argv = ["data", "--workspace", "ws", "--bound", "1", "--scale", "1",
            "--seed", "3", "--num_steps", "8", "--encoding", "frequency",
            "--camera", "nerf"]
    states = TSimulate.main(argv, device="cpu")
    assert states.shape == (8, 12) and np.isfinite(states).all()
    assert len(os.listdir("paths/ws/estimator_data")) == 7
    assert len(os.listdir("paths/ws/replan_poses")) == 2


@pytest.mark.parametrize("flag", ["--ff"])
def test_simulate_refuses_fused(flag, tmp_path, monkeypatch):
    """simulate --ff (the JAX estimator's Hessian through the fused
    kernel raises) exits before anything loads."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="--ff"):
        TSimulate.main(["data", flag], device="cpu")
    assert os.listdir(".") == []


@pytest.mark.parametrize("entry", ["simulate", "validate"])
def test_sequential_tcnn_runs(entry, seq_dir, capsys):
    """simulate --tcnn and sequential validate --tcnn (Gaussian UQ): the
    estimator's Hessian through the biased NeRFNetworkTCNN, whose MLPs
    are plain chains; JAX's sequential validate --tcnn runs to its end on
    the CPU (its root simulate.py stops at a NameError for every flag,
    ROADMAP Queue 3). Here on the raw position (`--encoding None`, see
    test_torch_validate.TCNN); both were refused before the net was
    ported."""
    from test_torch_validate import TCNN, _tcnn_workdir
    _tcnn_workdir(seq_dir, "Gaussian Approximation", sims=1)
    env = json.loads(Path("envConfig.json").read_text())
    env["estimator_cfg"]["batch_size"] = 64
    Path("envConfig.json").write_text(json.dumps(env))
    argv = [a for a in TCNN if a != "--batched_rollouts"] + [
        "--camera", "nerf"]
    if entry == "simulate":
        states = TSimulate.main(argv, device="cpu")
        assert states.shape[1] == 12 and np.isfinite(states).all()
        return
    V.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert ".End of validation.." in out
    rows = _rows("results/collisionValuesBlenderMC_n1.csv")
    assert rows and all(len(r) == 24 for r in rows)


def test_jax_sequential_ff_hessian_raises():
    """Why validate refuses --ff on the sequential path: the JAX
    estimator's posterior (estimator.py:284, jax.hessian of
    measurement_fn) through a fused toy net (the custom_vjp fused_mlp)
    raises ValueError, which the JAX CLI's restart loop takes for a
    missing path, drawing paths forever."""
    import jax.numpy as jnp
    from nerfsafetyvalidation_tpu.config import NetworkConfig
    from nerfsafetyvalidation_tpu.data.rays import get_rays
    from nerfsafetyvalidation_tpu.models import renderer as JR
    from nerfsafetyvalidation_tpu.models.network import NeRFNetwork
    from nerfsafetyvalidation_tpu.nav.estimator import Estimator
    net = NeRFNetwork(NetworkConfig(num_levels=2, desired_resolution=32,
                                    bound=1.0, fused=True))
    p = net.init(jax.random.PRNGKey(0))
    est = Estimator(
        {"batch_size": 4, "kernel_size": 3, "dil_iter": 1, "lrate": 1e-3,
         "N_iter": 1, "sig0": np.eye(12), "Q": np.eye(12)}, None,
        np.zeros(12, np.float32),
        get_rays_fn=lambda pose: get_rays(pose, (8.0, 8.0, 4.0, 4.0), 8, 8),
        render_fn=lambda o, d: JR.render(net, p, o, d, num_steps=4,
                                         bg_color=1.0))
    args = (jnp.zeros(12), jnp.eye(12), jnp.full((8, 8, 3), 0.5),
            jnp.asarray([[1, 2], [3, 4], [5, 6], [7, 0]]))
    with pytest.raises(ValueError):    # traced under jit: nothing runs
        jax.jit(jax.hessian(lambda x: est.measurement_fn(x, *args)))(
            jnp.full(12, 0.01))
