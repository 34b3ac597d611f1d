"""The core batched rollout engine and its helpers, port
(nerfsafetyvalidation_tpu_torch/validation/) against the JAX package on the
CPU, on tests/test_validation.py's wall SDF (free space but x > 0.5 m,
10 steps of 0.1 s, disturbance std 0.05), the JAX package's own draws
handed to the port:

  * `run`: positions, SDF values, collisions (the state frozen after the
    first), log-likelihoods, risk;
  * `sample_noises` (diagonal and full covariance), `monte_carlo`, `cem`;
  * `_cem_proposal_update`, `_weighted_mean_cov`, `_mvn_logpdf`;
  * `build_sdf` from a density function (numpy, or a tensor-valued net);
  * the port's `bench_rollouts` at toy sizes: its two JSON lines."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.validation import batched as JB
from nerfsafetyvalidation_tpu.validation.stresstests import cross_entropy \
    as JCE
from nerfsafetyvalidation_tpu.validation.utils import sdf as JS
from nerfsafetyvalidation_tpu_torch import bench_rollouts
from nerfsafetyvalidation_tpu_torch.validation import batched as TB
from nerfsafetyvalidation_tpu_torch.validation.stresstests import \
    cross_entropy as TCE
from nerfsafetyvalidation_tpu_torch.validation.utils import sdf as TS

torch.set_num_threads(1)

T = 10


def _kw():
    actions = np.tile(np.asarray([10.0, 0, 0, 0], dtype=np.float32), (T, 1))
    g = 20
    xs = np.linspace(-1, 1, g)
    sdf = np.ones((g, g, g), dtype=np.float32)
    sdf[xs > 0.5] = 0.0
    return dict(actions=actions, dt=0.1, g=10.0, mass=1.0, I=np.eye(3),
                sdf=sdf, sdf_start=[-1, -1, -1], granularity=g / 2,
                noise_mean=np.zeros(12),
                noise_std=np.full(12, 0.05, dtype=np.float32),
                start_state=np.zeros(12, dtype=np.float32))


@pytest.fixture(scope="module")
def engines():
    return (JB.BatchedRolloutEngine(**_kw()),
            TB.BatchedRolloutEngine(device="cpu", **_kw()))


def _z(key, n):
    return np.asarray(jax.random.normal(key, (n, T, 12)))


# float32 on both sides: positions agree to 1 ulp of their sums (measured
# 1.2e-7), log-likelihoods of ~20 to 3.8e-6; SDF values and collisions
# exactly
TOL = dict(rtol=1e-5, atol=1e-5)


def _compare(out_t, out_j):
    for k in ("collided", "ever_collided", "sdf_vals", "risk"):
        if k not in out_j:          # monte_carlo keeps no per-step ones
            continue
        np.testing.assert_array_equal(np.asarray(out_t[k]),
                                      np.asarray(out_j[k]), err_msg=k)
    for k in ("positions", "log_likelihoods"):
        np.testing.assert_allclose(np.asarray(out_t[k]),
                                   np.asarray(out_j[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("push", [-0.1, 0.0, 0.2])
def test_run_matches_jax(engines, push):
    """JAX's MC disturbances plus a push along x (metres a step): away from
    the wall none of 64 sims collides, without a push some do, pushed into
    it all do."""
    eng_j, eng_t = engines
    noises = np.array(eng_j.sample_noises(jax.random.PRNGKey(0), 64))
    noises[..., 0] += push
    out_j = eng_j.run(jnp.asarray(noises))
    out_t = eng_t.run(torch.from_numpy(noises))
    _compare(out_t, out_j)
    ever = out_t["ever_collided"].numpy()
    assert {-0.1: not ever.any(), 0.0: 0 < ever.mean() < 1,
            0.2: ever.all()}[push]


def test_frozen_after_first_collision(engines):
    _, eng_t = engines
    noises = np.zeros((4, T, 12), dtype=np.float32)
    noises[..., 0] = 0.2
    out = eng_t.run(noises)
    assert bool(out["ever_collided"].all())
    pos = out["positions"][0, :, 0].numpy()
    first = int(out["collided"][0].int().argmax())
    assert first < T - 1 and np.all(pos[first:] == pos[first])
    assert int(out["collided"].sum()) == 4            # the first hit only


def test_sdf_lookup_out_of_bounds_reads_9999(engines):
    _, eng_t = engines
    pos = torch.tensor([[0.0, 0.0, 0.0], [1.2, 0.0, 0.0], [0.0, -1.01, 0.0],
                        [0.6, 0.0, 0.0]])
    np.testing.assert_array_equal(eng_t._sdf_lookup(pos).numpy(),
                                  [1.0, 9999.0, 9999.0, 0.0])


def test_log_likelihood_clip(engines):
    """A disturbance 10 std off clips at log 1e-8 per dimension, as the
    JAX version clips it."""
    eng_j, eng_t = engines
    noise = np.zeros((3, 12), dtype=np.float32)
    noise[1] = 0.5
    noise[2, :6] = 0.03
    got = eng_t._log_likelihood(torch.from_numpy(noise)).numpy()
    want = jax.vmap(eng_j._log_likelihood)(jnp.asarray(noise))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got[1], 12 * np.log(np.float32(1e-8)),
                               rtol=1e-6)


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_sample_noises_matches_jax(engines, cov):
    """JAX's draws of PRNGKey(5) handed in: means + stds z, or means + L z
    with L the Cholesky factor of a full covariance."""
    eng_j, eng_t = engines
    rng = np.random.default_rng(3)
    means = np.tile(rng.normal(size=12).astype(np.float32), (T, 1))
    A = rng.normal(size=(12, 12)) * 0.05
    full = np.broadcast_to(A @ A.T + 0.01 * np.eye(12), (T, 12, 12))
    kw = dict(covs=full) if cov == "full" else dict(
        covs_diag=np.full((T, 12), 0.003, np.float32))
    want = eng_j.sample_noises(jax.random.PRNGKey(5), 8, jnp.asarray(means),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    got = eng_t.sample_noises(None, 8, means, z=_z(jax.random.PRNGKey(5), 8),
                              **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_sample_noises_from_a_generator(engines):
    _, eng_t = engines
    a, b = (eng_t.sample_noises(torch.Generator().manual_seed(1), 16)
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (16, T, 12)
    np.testing.assert_allclose(float(a.std()), 0.05, rtol=0.1)


def test_monte_carlo_matches_jax(engines):
    eng_j, eng_t = engines
    key = jax.random.PRNGKey(0)
    out_j = eng_j.monte_carlo(key, 64)
    out_t = eng_t.monte_carlo(None, 64, z=_z(key, 64))
    _compare(out_t, out_j)
    np.testing.assert_array_equal(out_t["first_collision_step"],
                                  out_j["first_collision_step"])
    assert out_t["collision_rate"] == out_j["collision_rate"]
    np.testing.assert_allclose(out_t["noises"], out_j["noises"], rtol=1e-6)


def test_cem_matches_jax(engines):
    """Three CEM iterations of 16 sims and 4 elites, JAX's draws per
    iteration handed in (its key split as its `cem` splits it)."""
    eng_j, eng_t = engines
    key, z = jax.random.PRNGKey(0), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        z.append(_z(sub, 16))
    res_j = eng_j.cem(jax.random.PRNGKey(0), m=16, m_elite=4, kmax=3)
    res_t = eng_t.cem(None, m=16, m_elite=4, kmax=3, z=z)
    for k in ("means", "covs", "vars"):
        np.testing.assert_allclose(res_t[k], res_j[k], rtol=1e-4, atol=1e-8,
                                   err_msg=k)
    assert res_t["history"] == pytest.approx(res_j["history"], rel=1e-6)
    assert (res_t["vars"] > 0).all() and (res_t["vars"] <= 0.1 + 1e-9).all()


def test_cem_proposal_update_matches_jax():
    rng = np.random.default_rng(7)
    E, S = 6, 4
    elite = rng.normal(0, 0.3, size=(E, S, 12))
    q_mean = rng.normal(0, 0.1, size=(S, 12))
    p_mean = np.zeros((S, 12))
    q_cov = np.broadcast_to(0.04 * np.eye(12), (S, 12, 12)).copy()
    p_cov = np.broadcast_to(0.09 * np.eye(12), (S, 12, 12)).copy()
    got = TB._cem_proposal_update(elite, q_mean, q_cov, p_mean, p_cov)
    want = JB._cem_proposal_update(elite, q_mean, q_cov, p_mean, p_cov)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    x = rng.normal(size=(5, 12))
    np.testing.assert_array_equal(
        TB.BatchedRolloutEngine._mvn_logpdf(x, q_mean[0], q_cov[0]),
        JB.BatchedRolloutEngine._mvn_logpdf(x, q_mean[0], q_cov[0]))
    np.testing.assert_array_equal(
        TB.BatchedRolloutEngine._diag_logpdf(x, q_mean[0], 0.04),
        JB.BatchedRolloutEngine._diag_logpdf(x, q_mean[0], 0.04))


@pytest.mark.parametrize("weights", ["random", "one_elite"])
def test_weighted_mean_cov_matches_jax(weights):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(10, 3))
    w = rng.uniform(0.1, 1.0, size=10) if weights == "random" \
        else np.eye(10)[3]
    with np.errstate(all="raise"):
        got = TCE._weighted_mean_cov(x, w)
    for a, b in zip(got, JCE._weighted_mean_cov(x, w)):
        np.testing.assert_array_equal(a, b)


def test_core_engine_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="slice G"):
        TB.BatchedRolloutEngine(device="cpu", mesh=object(), **_kw())


@pytest.mark.parametrize("fn", ["numpy", "tensor"])
def test_build_sdf_matches_jax(fn, tmp_path):
    """A ball of density 100 and radius 0.3 on a 10-cells-a-metre grid over
    [-1, 1)^3; the port's density function may return a tensor."""
    def density(pts):
        return 100.0 * (np.linalg.norm(pts, axis=-1) < 0.3)

    def density_t(pts):
        return torch.from_numpy(density(pts))

    kw = dict(start=(-1, -1, -1), end=(1, 1, 1), granularity=10)
    want = JS.build_sdf(density, **kw)
    got = TS.build_sdf(density if fn == "numpy" else density_t,
                       out_path=str(tmp_path / "sdf.npy"), **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "sdf.npy"), want)
    assert got.min() == 0.0 and got.max() > 0.3
    cmap = TS.collision_map_from_density(density, **kw)
    np.testing.assert_array_equal(
        TS.sdf_from_collision_map(cmap, 10),
        JS.sdf_from_collision_map(cmap, 10))


def test_bench_rollouts_toy(monkeypatch, capsys):
    """The port's bench_rollouts at toy sizes on the CPU: two JSON lines
    with the JAX script's keys and metric strings."""
    for name, value in dict(N_SIMS=64, N_ITERS=1, M_FULL=2, OBS_RES=8,
                            RENDER_STEPS=4, N_ITERS_FULL=1).items():
        monkeypatch.setattr(bench_rollouts, name, value)
    lines = bench_rollouts.main(device="cpu")
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    assert printed == lines and len(lines) == 2
    for line in lines:
        assert set(line) >= {"metric", "value", "unit", "vs_baseline"}
        assert line["unit"] == "rollouts/s" and line["value"] > 0
    assert lines[0]["metric"] == (
        "rollouts/sec (batched 12-step MC rollouts, dynamics+SDF+likelihood "
        "core ONLY, population 64)")
    assert lines[1]["metric"] == (
        "rollouts/sec (FULL-fidelity 12-step rollouts: 8^2 NeRF obs render "
        "+ Gaussian UQ + reward + SDF in-scan, population 2)")
