"""The port's Gaussian UQ (nerfsafetyvalidation_tpu_torch/uq/) and its
distributions (validation/distributions.py) against the JAX package's on
the CPU:

  * the sufficient statistics and (mu_d, sigma_d) from the same render
    extras, and from each package's own staged frame of the same net and
    pose (tests/torch_sequential_nets.py);
  * `uncertainty()` online (the render tuple of render_for_uncertainty)
    and offline (a training directory's images), and its refusals;
  * `mvn_log_prob`, and `SeedableMultivariateNormal`'s samples and
    `compute_best_solution` from the JAX package's threefry draws handed
    to the port as standard normals."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sequential_nets as S
from nerfsafetyvalidation_tpu.uq import orchestrator as JO
from nerfsafetyvalidation_tpu.uq.gaussian_approximation import \
    GaussianApproximationDensityUncertainty as JGA
from nerfsafetyvalidation_tpu.validation import distributions as JD
from nerfsafetyvalidation_tpu.validation.simulators.toy_simulator import \
    ToySimulator as JToy
from nerfsafetyvalidation_tpu_torch.uq import orchestrator as TO
from nerfsafetyvalidation_tpu_torch.uq.gaussian_approximation import (
    GaussianApproximationDensityUncertainty as TGA, sufficient_statistics)
from nerfsafetyvalidation_tpu_torch.validation import distributions as TD
from nerfsafetyvalidation_tpu_torch.validation.simulators import \
    ToySimulator as TToy

torch.set_num_threads(1)

# the camera: 2 m out on -x, looking along +x at the seeded field
POSE = np.float32([[0, 0, 1, -2.0], [1, 0, 0, 0.0], [0, 1, 0, 0.0],
                   [0, 0, 0, 1]])


@pytest.fixture(scope="module")
def frames():
    """Each package's staged frame of POSE, as render_for_uncertainty
    returns it (the last chunk's rgbs and sigmas)."""
    net_j, p_j, net_t = S.nets()
    jf, tf = S.jax_fns(net_j, p_j), S.port_fns(net_t)
    rj = jf["get_rays_fn"](jnp.asarray(POSE)[None])
    oj = jf["render_fn"](rj["rays_o"], rj["rays_d"])
    rt = tf["get_rays_fn"](torch.from_numpy(POSE)[None])
    with torch.no_grad():
        ot = tf["render_fn"](rt["rays_o"], rt["rays_d"])
    return {"jax": (oj, rj["rays_o"], rj["rays_d"]),
            "port": (ot, rt["rays_o"], rt["rays_d"]), "fns": (jf, tf)}


def _np(out):
    return {k: np.asarray(out[k]) for k in ("rgbs", "sigmas", "image")}


# The Gaussian MLE has no interior minimum: at mu_d = mean(r) / sum(c d)
# the objective is log(sum(c^2 d^2) sigma_d^2), unbounded below as
# sigma_d -> 0, so scipy's BFGS stops at a sigma_d of the order of its
# gradient tolerance (about 1e-5 here, of either sign), and rounding-level
# differences in the sums move where it stops. From the same sums the fit
# is the same bits; from each package's own sums (float32, other
# summation orders: measured 1.5e-7 relative) (mu_d, sigma_d) are held to
# 1e-4 of the fit's starting point (mean(d), std(d)): measured 5.8e-7 and
# 1.2e-5 of 1.3 and 0.48.
FIT_TOL = 1e-4


def _close_fit(got, want, start):
    assert abs(got[0] - want[0]) <= FIT_TOL * abs(start[0]), (got, want)
    assert abs(got[1] - want[1]) <= FIT_TOL * abs(start[1]), (got, want)


def test_same_extras_match_jax(frames):
    """JAX's render extras into both: the five sums (bound 1e-5
    relative), the fit from JAX's own sums bit-equal, and from the port's
    at FIT_TOL."""
    ex = _np(frames["jax"][0])
    j = JGA(ex["rgbs"], ex["sigmas"], ex["image"])
    t = TGA(*(torch.tensor(ex[k]) for k in ("rgbs", "sigmas", "image")))
    keys = ("S_c2d2", "S_cd", "r_mean", "d_mean", "d_std")
    np.testing.assert_allclose([getattr(t, k) for k in keys],
                               [getattr(j, k) for k in keys], rtol=1e-5)
    want = j.optimize()
    _close_fit(t.optimize(), want, (j.d_mean, j.d_std))
    for k in keys:
        setattr(t, k, getattr(j, k))
    assert t.optimize() == want


def test_online_uncertainty_matches_jax(frames, capsys):
    """uncertainty() online, each package on its own staged frame: the
    frames agree to float32 (bound 1e-5 on the image), (mu_d, sigma_d) at
    FIT_TOL."""
    oj, ot = frames["jax"][0], frames["port"][0]
    np.testing.assert_allclose(ot["image"].numpy(), np.asarray(oj["image"]),
                               atol=1e-5)
    j = JO.uncertainty("Gaussian Approximation", rendered_output=frames["jax"],
                       H=S.RES, W=S.RES)
    t = TO.uncertainty("Gaussian Approximation",
                       rendered_output=frames["port"], H=S.RES, W=S.RES)
    g = JGA(oj["rgbs"], oj["sigmas"], oj["image"])
    _close_fit(t, j, (g.d_mean, g.d_std))
    assert capsys.readouterr().out.count("sigma_d_opt =") == 2
    stats = sufficient_statistics(ot["rgbs"], ot["sigmas"], ot["image"])
    assert stats.shape == (5,) and bool(torch.isfinite(stats).all())


def _per_image(out):
    """The (mu_d, sigma_d) of each 'Image #i (name): ...' line."""
    rows = {}
    for line in out.splitlines():
        if line.startswith("Image #"):
            name = line.split("(")[1].split(")")[0]
            mu = float(line.split("mu_d_opt = ")[1].split(",")[0])
            rows[name] = (mu, float(line.split("sigma_d_opt = ")[1]))
    return rows


def test_offline_uncertainty_matches_jax(frames, tmp_path, monkeypatch,
                                         capsys):
    """The offline sweep over a training directory's images (their
    cameras from transforms_train.json): each image's (mu_d, sigma_d)
    within FIT_TOL of (1.0, 0.5) of JAX's (the fits start near (1.3,
    0.48) here), the kept lists those with 0 < sigma_d < 3, and the heat
    map written when one is kept."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("data/train")
    frames_json = []
    for k in range(3):
        pose = POSE.copy()
        pose[1, 3] = 0.1 * k
        frames_json.append({"file_path": f"./train/img{k}",
                            "transform_matrix": pose.tolist()})
        open(f"data/train/img{k}.png", "wb").close()
    with open("data/transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": frames_json}, f)
    jf, tf = frames["fns"]
    kw = dict(path_to_images="data/train", dataset_path="data", H=S.RES,
              W=S.RES)
    JO.uncertainty("Gaussian Approximation", render_fn=jf["render_fn"],
                   get_rays_fn=jf["get_rays_fn"], **kw)
    want = _per_image(capsys.readouterr().out)
    t = TO.uncertainty("Gaussian Approximation", render_fn=tf["render_fn"],
                       get_rays_fn=tf["get_rays_fn"], **kw)
    got = _per_image(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == [f"img{k}.png" for k in range(3)]
    for name in got:
        _close_fit(got[name], want[name], (1.0, 0.5))
    kept = [v for v in got.values() if 0 < v[1] < 3]
    assert t["optimized_mu_d"] == [v[0] for v in kept]
    assert t["optimized_sigma_d"] == [v[1] for v in kept]
    assert os.path.exists("results/uncertainty_heatmap.png") == bool(kept)


def test_uncertainty_refusals():
    """An unknown method raises ValueError, as in the JAX package."""
    with pytest.raises(ValueError):
        TO.uncertainty("Nope", rendered_output={})
    with pytest.raises(ValueError):
        JO.uncertainty("Nope", rendered_output={})


# ---------------------------------------------------------- distributions
def _mvn(seed=0, k=4, steps=3):
    rng = np.random.default_rng(seed)
    means = [rng.normal(size=k).astype(np.float32) for _ in range(steps)]
    covs = []
    for _ in range(steps):
        A = rng.normal(size=(k, k))
        covs.append((A @ A.T / k + np.eye(k)).astype(np.float32))
    return means, covs


def test_log_prob_matches_jax():
    """float32 Cholesky solves in both: bound 1e-5 relative."""
    means, covs = _mvn()
    x = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    for m, c in zip(means, covs):
        want = [float(JD.mvn_log_prob(xi, m, c)) for xi in x]
        got = TD.mvn_log_prob(torch.from_numpy(x), torch.from_numpy(m),
                              torch.from_numpy(c))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        assert float(TD._Dist(m, c).log_prob(x[0])) == pytest.approx(
            want[0], rel=1e-5)


def _jax_normals(key, steps, k):
    keys = jax.random.split(key, steps)
    return np.stack([np.asarray(jax.random.normal(kk, (k,)))
                     for kk in keys])


def test_samples_from_jax_draws():
    """sample(sim) with the JAX package's standard normals (split of
    fold_in(PRNGKey(seed), sim)) equals JAX's sample(sim): mean + L z in
    float32 (bound 1e-6)."""
    means, covs = _mvn()
    jd = JD.SeedableMultivariateNormal(means, covs, noise_seed=7)
    td = TD.SeedableMultivariateNormal(means, covs, noise_seed=7)
    for sim in (0, 3):
        z = _jax_normals(jax.random.fold_in(jax.random.PRNGKey(7), sim),
                         len(means), 4)
        want = [np.asarray(v) for v in jd.sample(sim)]
        got = [v.numpy() for v in td.sample(sim, z=z)]
        np.testing.assert_allclose(got, want, atol=1e-6)
    # the port's own streams: reproducible, one a simulation
    a = torch.stack(td.sample(5))
    assert torch.equal(a, torch.stack(td.sample(5)))
    assert not torch.equal(a, torch.stack(td.sample(6)))
    assert torch.equal(a, torch.stack(TD.SeedableMultivariateNormal(
        means, covs, noise_seed=7).sample(5)))


def test_compute_best_solution_from_jax_draws():
    """compute_best_solution on the toy simulator, the port handed JAX's
    draws (the key chain of fold_in(base, 2^30)): the same best step."""
    steps = 6
    means = [np.float32([0.8, 0.9])] * steps
    covs = [np.eye(2, dtype=np.float32) * 0.25] * steps
    jd = JD.SeedableMultivariateNormal(means, covs, noise_seed=3)
    td = TD.SeedableMultivariateNormal(means, covs, noise_seed=3)
    key = jax.random.fold_in(jax.random.PRNGKey(3), TD.BEST_SOLUTION_STREAM)
    z = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        z.append(np.asarray(jax.random.normal(sub, (2,))))
    bm_j, bc_j, bv_j = jd.compute_best_solution(JToy(10.0))
    bm_t, bc_t, bv_t = td.compute_best_solution(TToy(10.0), z=np.stack(z))
    np.testing.assert_allclose(bv_t, bv_j, rtol=1e-6)
    np.testing.assert_array_equal(bm_t.numpy(), np.asarray(bm_j))
    np.testing.assert_array_equal(bc_t.numpy(), np.asarray(bc_j))
    with pytest.raises(Exception):
        TD.SeedableMultivariateNormal([np.zeros(2)], [-np.eye(2)])
