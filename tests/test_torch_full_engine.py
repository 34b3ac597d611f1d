"""The full-fidelity batched rollout engine and the frames' UQ moments,
port (nerfsafetyvalidation_tpu_torch/validation/batched.py,
models/renderer.py) against the JAX package on the CPU, from the same
weights and draws:

  * `render_frame_fast` and `render_frame_guided` (march and scout
    prepasses) with `return_moments`, on orthographic rays whose direction
    components are powers of two (XLA on the CPU contracts o + t d into an
    FMA, PyTorch does not; with these rays every product is exact and the
    march takes the same path in both packages), and `march_tile`, which
    changes no frame in either package;
  * `FullBatchedRolloutEngine` on all four `obs_render` paths, T = 2 steps,
    m = 4 sims, 18^2 observations (not a multiple of the prepass factor 4),
    a wall in the SDF beside the start, so that some sims collide: the
    Monte Carlo run with JAX's standard normals handed in, then CEM with
    JAX's draws per iteration, both CSV schemas.

The net is a 2-level hash-grid `NeRFNetwork` (random weights drawn by numpy
in the JAX pytree's shapes, carried across with `params_from_jax`), float32
and unfused in both packages: the CPU UQ parity holds the unclipped route,
trunc_exp = exp on both sides. The card's kernels (K1, K3) clip the sigma
pre-activation at +-15, as the JAX package's Pallas kernels do, and K4
rounds it to bf16; those routes are held to their plain versions on the
card by chip_smoke.py, which also counts the samples with s0 > 15 (ROADMAP
Queue 3).

Each JAX engine is built and run once per module (a module-scoped
fixture); JAX compiles one program per engine."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models.network import NeRFNetwork as JNet
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.ops import ray_ops as JO
from nerfsafetyvalidation_tpu.validation import batched as JB
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.data.synthetic import orbit_pose
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.validation import batched as TB

torch.set_num_threads(1)

G = 32
NET = dict(num_levels=2, desired_resolution=32, bound=1.0, grid_ray=True,
           grid_size=G)
RES = 18                    # observations: not a multiple of FACTOR
FACTOR = 4
T = 2
M = 4
PATHS = ("uniform", "fast", "guided", "scout")


@pytest.fixture(scope="module")
def nets():
    """(JAX net, its params, the port's net): weights N(0, 0.2) in the JAX
    pytree's shapes, the table uniform in +-1."""
    net_j = JNet(JConfig(**NET))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.2, s.shape).astype(np.float32), shapes)
    emb = p["encoder"]["embeddings"]
    p["encoder"]["embeddings"] = rng.uniform(-1, 1, emb.shape).astype(
        np.float32)
    net_t = make_network(TConfig(**NET), params_from_jax(p, device="cpu"),
                         device="cpu")
    return net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


@pytest.fixture(scope="module")
def ball():
    """(JAX state, port state): occupied cells in a ball of radius 0.35 at
    NGP (0, 0, -0.45), clear of the frame's filler rays (origin 0,
    direction +z), which then shade nothing."""
    g = np.arange(G)
    ijk = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    c = 2.0 * (ijk + 0.5) / G - 1.0
    grid = np.zeros((1, G ** 3), np.float32)
    inside = np.linalg.norm(c - [0.0, 0.0, -0.45], axis=-1) < 0.35
    grid[0, np.asarray(JO.morton3d(jnp.asarray(ijk)))] = \
        np.where(inside, 20.0, 0.0)
    gj = jnp.asarray(grid)
    s_j = JR.RendererState(gj, JO.packbits(gj, 10.0), jnp.asarray(20.0),
                           jnp.asarray(1),
                           JO.occupancy_to_skip_grid(gj > 10.0, G))
    s_t = TR.RendererState(
        density_bitfield=torch.from_numpy(np.array(s_j.density_bitfield)),
        density_grid=torch.from_numpy(grid),
        mean_density=torch.tensor(20.0), iter_density=torch.tensor(1),
        skip_grid=torch.from_numpy(np.array(s_j.skip_grid)))
    return s_j, s_t


# ------------------------------------------------------------------ frames
def _ortho_rays(res=32):
    """res^2 orthographic rays from z = -2.5, direction (2^-4, -2^-3, 1)."""
    c = (np.arange(res) + 0.5) / res * 1.6 - 0.8
    yy, xx = np.meshgrid(c, c, indexing="ij")
    o = np.stack([xx.ravel(), yy.ravel(), np.full(res * res, -2.5)],
                 -1).astype(np.float32)
    d = np.broadcast_to(np.float32([0.0625, -0.125, 1.0]), o.shape).copy()
    return o, d


FRAMES = {
    "fast": dict(tile=512, max_samples=16, max_steps=64, dt_gamma=1.0 / 64,
                 bg_color=1.0),
    "guided_march": dict(prepass_factor=FACTOR, max_samples=8, tile=256,
                         max_steps=64, dt_gamma=1.0 / 64,
                         prepass_mode="march"),
    "guided_scout": dict(prepass_factor=FACTOR, max_samples=8, tile=256,
                         prepass_mode="scout"),
}


def _frame_pair(name, nets, ball, **extra):
    net_j, p_j, net_t = nets
    s_j, s_t = ball
    o, d = _ortho_rays()
    kw = dict(FRAMES[name], return_moments=True, **extra)
    JR._FRAME_FAST_CACHE.clear()
    JR._FRAME_GUIDED_CACHE.clear()
    if name == "fast":
        ref = JR.render_frame_fast(net_j, p_j, s_j, jnp.asarray(o),
                                   jnp.asarray(d), **kw)
        got = TR.render_frame_fast(net_t, s_t, torch.from_numpy(o),
                                   torch.from_numpy(d), **kw)
    else:
        ref = JR.render_frame_guided(net_j, p_j, s_j, jnp.asarray(o),
                                     jnp.asarray(d), 32, 32,
                                     natural_tile_cap=kw["tile"], **kw)
        got = TR.render_frame_guided(net_t, s_t, torch.from_numpy(o),
                                     torch.from_numpy(d), 32, 32, **kw)
    return ref, got


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_moments_match_jax(name, nets, ball):
    """uq_moments [S_c2d2, S_cd, S_d, S_d2] and the image, float32 on both
    sides: the sums run in other orders (XLA's reductions against
    PyTorch's); measured rel 1.1e-6 at most; bound rtol 2e-5."""
    ref, got = _frame_pair(name, nets, ball)
    ws = np.asarray(ref["weights_sum"])
    assert (ws > 0.3).mean() > 0.05 and (ws < 0.01).mean() > 0.3
    mom = np.asarray(ref["uq_moments"])
    assert mom.shape == (4,) and (mom > 1.0).all()
    np.testing.assert_allclose(got["uq_moments"].numpy(), mom, rtol=2e-5)
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(ref["image"]), rtol=1e-5,
                               atol=1e-5)


def test_frame_without_moments_has_none(nets, ball):
    o, d = (torch.from_numpy(a) for a in _ortho_rays())
    out = TR.render_frame_fast(nets[2], ball[1], o, d, **FRAMES["fast"])
    assert "uq_moments" not in out


def test_march_tile_changes_nothing(nets, ball):
    """Two march tiles give the port one frame, bit for bit, and JAX's
    frame at a third march tile (JAX marches per tile) within
    test_frame_moments_match_jax's bounds."""
    o, d = (torch.from_numpy(x) for x in _ortho_rays())
    a, b = (TR.render_frame_fast(nets[2], ball[1], o, d, march_tile=mt,
                                 return_moments=True, **FRAMES["fast"])
            for mt in (128, 512))
    for k in ("image", "uq_moments", "depth", "weights_sum"):
        assert torch.equal(a[k], b[k]), k
    ref, got = _frame_pair("fast", nets, ball, march_tile=256)
    assert torch.equal(got["uq_moments"], a["uq_moments"])
    np.testing.assert_allclose(a["uq_moments"].numpy(),
                               np.asarray(ref["uq_moments"]), rtol=2e-5)


# ------------------------------------------------------------------ engine
def _engine_kw():
    fx = 0.5 * RES / np.tan(0.5 * 0.6911)
    start = TB.start_state_from_pose(orbit_pose(0.77, 0.52, 2.4))
    # free space (1 m) everywhere but a wall at x >= 1.5 m, 1 cm past the
    # start: about half the sims hit it
    sdf = np.ones((40, 40, 40), np.float32)
    sdf[35:] = 0.0
    return dict(
        actions=np.tile(np.float32([10.0, 0.01, 0.0, 0.0]), (T, 1)),
        dt=0.1, g=10.0, mass=1.0, I=np.eye(3, dtype=np.float32), sdf=sdf,
        sdf_start=[-2.0, -2.0, -2.0], granularity=10,
        noise_mean=np.zeros(12, np.float32),
        noise_std=np.full(12, 0.05, np.float32), start_state=start,
        obs_res=RES, grid_max_samples=8, render_steps=16,
        base_intrinsics=(fx, fx, RES / 2, RES / 2), base_res=RES,
        obs_prepass_factor=FACTOR)


def _z(seed, m=M):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (m, T, 12)))


def _engines(path, nets, ball, **extra):
    net_j, p_j, net_t = nets
    s_j, s_t = (None, None) if path == "uniform" else ball
    kw = dict(_engine_kw(), obs_render=path, **extra)
    return (JB.FullBatchedRolloutEngine(net=net_j, params=p_j,
                                        renderer_state=s_j, **kw),
            TB.FullBatchedRolloutEngine(net=net_t, renderer_state=s_t,
                                        device="cpu", **kw))


@pytest.fixture(scope="module", params=PATHS)
def mc(request, nets, ball):
    """(path, JAX engine, port engine, JAX's outputs, the port's), each as
    {'mc': the Monte Carlo run, 'verbatim': the run with each disturbance
    sampled verbatim (adapt_std=False, as CEM samples)}, the port handed
    JAX's standard normals of PRNGKey(1)."""
    eng_j, eng_t = _engines(request.param, nets, ball)
    z = _z(1)
    out_j = {"mc": eng_j.monte_carlo(jax.random.PRNGKey(1), M),
             "verbatim": {k: np.asarray(v) for k, v in
                          eng_j.run(z, adapt_std=False).items()}}
    out_t = {"mc": eng_t.monte_carlo(None, M, z=z),
             "verbatim": {k: v.numpy() for k, v in
                          eng_t.run(z, adapt_std=False).items()}}
    return request.param, eng_j, eng_t, out_j, out_t


def test_engine_dynamics_sdf_likelihood(mc):
    """With the disturbances sampled verbatim (nothing of the observation
    feeds back): disturbances, 4-point SDF check points and values,
    collisions and log-likelihoods, float32 on both sides. Measured 1.2e-7
    relative (disturbances), 0 (points), 3.8e-6 (log-likelihoods of ~20);
    bounds rtol 1e-5, atol 1e-5."""
    path, _, _, out_j, out_t = mc
    a, b = out_t["verbatim"], out_j["verbatim"]
    assert b["ever_collided"].any() and not b["ever_collided"].all()
    for k in ("collided", "ever_collided"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("noises", "positions", "sdf_vals", "log_likelihoods", "risk"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# rtol of sigma_d; the reward's atol follows as penalty_strength (36) x
# sigma_d's error: uniform and scout sample no march (measured rel 3.6e-6
# and 7.1e-7); fast and guided march from rays of normalised directions,
# where XLA's FMA moves a few rays onto another path (3 of 324 in one
# observation), their moments by ~1e-4 and, through 100 Adam steps,
# sigma_d by up to 4.8e-3 relative (reward 7.9e-2)
UQ_TOL = {"uniform": 2e-5, "scout": 2e-5, "fast": 2e-2, "guided": 2e-2}


def test_engine_uq_and_reward(mc):
    """The Monte Carlo run: sigma_d and the reward (and the reward carried
    into the next step) within UQ_TOL; the next step's disturbance is
    scaled by 1 + 0.01 reward, so the disturbances, points and
    log-likelihoods follow at 1e-2 of the reward's tolerance."""
    path, _, _, out_j, out_t = mc
    a, b = out_t["mc"], out_j["mc"]
    assert (b["sigma_d"] > 0.05).all()
    assert ((b["reward"] > -72.0) & (b["reward"] < 36.0)).all()
    tol = UQ_TOL[path]
    np.testing.assert_allclose(a["sigma_d"], b["sigma_d"], rtol=tol)
    for k in ("reward", "reward_prev"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=36 * tol,
                                   err_msg=k)
    np.testing.assert_array_equal(a["collided"], b["collided"])
    for k in ("noises", "positions", "log_likelihoods"):
        np.testing.assert_allclose(a[k], b[k], rtol=tol / 4, atol=tol,
                                   err_msg=k)


def test_engine_positions_equal_across_paths(nets, ball, mc):
    """The observation feeds only the reward: step 0 (before any reward
    scales a disturbance) lands on the same points on every path."""
    path, _, eng_t, _, out_t = mc
    other = TB.FullBatchedRolloutEngine(
        net=nets[2], renderer_state=None, device="cpu",
        **dict(_engine_kw(), obs_render="uniform"))
    base = other.run(_z(1))
    np.testing.assert_array_equal(out_t["mc"]["positions"][:, 0],
                                  base["positions"][:, 0].numpy())


def test_mc_csv_equal_to_jax(mc, tmp_path):
    """write_mc_csv of one output dict: the same file, byte for byte."""
    _, eng_j, eng_t, out_j, _ = mc
    out_j = out_j["mc"]
    eng_j.write_mc_csv(out_j, str(tmp_path / "j" / "mc.csv"))
    eng_t.write_mc_csv(out_j, str(tmp_path / "t" / "mc.csv"))
    a = (tmp_path / "j" / "mc.csv").read_bytes()
    assert a == (tmp_path / "t" / "mc.csv").read_bytes()
    rows = list(csv.reader(a.decode().splitlines()))
    n_rows = sum(int(np.argmax(c)) + 1 if c.any() else T
                 for c in out_j["collided"])
    assert len(rows) == n_rows and all(len(r) == 23 for r in rows)


def _read_csv(path):
    rows = list(csv.reader(open(path)))
    num = np.asarray([[float(v) for v in r[:-2]] for r in rows])
    flags = [r[-2:] for r in rows]
    return num, flags


def test_cem_matches_jax(mc, tmp_path):
    """Two CEM iterations (m 4, 2 elite) with JAX's draws per iteration (its
    key split as its `cem` splits it): the proposals, the history and the
    27-column CSV (the flags equal, the numbers within UQ_TOL: the risks
    are reward-scaled)."""
    path, eng_j, eng_t, _, _ = mc
    key, z = jax.random.PRNGKey(2), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        z.append(np.asarray(jax.random.normal(sub, (M, T, 12))))
    res_j = eng_j.cem(jax.random.PRNGKey(2), M, 2, 2,
                      csv_path=str(tmp_path / "j.csv"))
    res_t = eng_t.cem(None, M, 2, 2, csv_path=str(tmp_path / "t.csv"), z=z)
    tol = UQ_TOL[path]
    for k in ("means", "covs", "vars"):
        np.testing.assert_allclose(res_t[k], res_j[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    for h_t, h_j in zip(res_t["history"], res_j["history"]):
        for k in h_j:
            np.testing.assert_allclose(h_t[k], h_j[k], rtol=tol, atol=tol)
    num_j, flags_j = _read_csv(tmp_path / "j.csv")
    num_t, flags_t = _read_csv(tmp_path / "t.csv")
    assert num_j.shape[1] == 25 and flags_t == flags_j
    assert any(f[0] == "True" for f in flags_j)
    np.testing.assert_allclose(num_t, num_j, rtol=tol, atol=36 * tol)


def test_obs_group_equals_single(nets):
    """obs_group 2 (the uniform observations of two sims in one `run`, the
    last group of 3 sims a single one) gives what obs_group 1 gives."""
    kw = dict(_engine_kw(), obs_render="uniform")
    one = TB.FullBatchedRolloutEngine(net=nets[2], device="cpu", **kw)
    two = TB.FullBatchedRolloutEngine(net=nets[2], device="cpu",
                                      obs_group=2, **kw)
    z = _z(3, m=3)
    a, b = one.run(z), two.run(z)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("what", ["laplace", "mesh", "no_state", "no_net"])
def test_engine_refuses(what, nets):
    """laplace: an unknown uq_method. The Laplace UQ itself is taken on
    the mip-fold teacher, which has the sigma-net flatpack (the case once
    checked that it refused it): its draws are the sigma net's size."""
    kw = dict(_engine_kw(), net=nets[2], device="cpu")
    err = NotImplementedError
    if what == "laplace":
        kw["uq_method"] = "laplace"
        kw["net"] = make_network(TConfig(
            encoding="mipfold", bound=1.0, num_levels=5, level_dim=2,
            base_resolution=4, fold_max_scale=16, log2_hashmap_size=10,
            grid_size=16, grid_ray=True), None, device="cpu", trainable=True,
            generator=torch.Generator().manual_seed(1))
        eng = TB.FullBatchedRolloutEngine(**kw)
        theta0, perts = eng._laplace_draws(torch.Generator().manual_seed(0),
                                           3)
        n = sum(w.numel() for w in kw["net"].sigma_net)
        assert theta0.shape == (3, n) and perts.shape == (
            3, eng.laplace_perturbations, eng.laplace_points, 3)
        kw["uq_method"], err = "bayes", ValueError
    elif what == "mesh":
        kw["mesh"] = object()
    elif what == "no_state":
        kw["obs_render"], err = "fast", ValueError
    else:
        kw["net"], err = None, ValueError
    match = {"laplace": "uq_method", "mesh": "slice G",
             "no_state": "renderer_state", "no_net": "net"}[what]
    with pytest.raises(err, match=match):
        TB.FullBatchedRolloutEngine(**kw)


# ---------------------------------------------------------------------- UQ
def _uq_engines(iters=100):
    ej = JB.FullBatchedRolloutEngine.__new__(JB.FullBatchedRolloutEngine)
    et = TB.FullBatchedRolloutEngine.__new__(TB.FullBatchedRolloutEngine)
    for e in (ej, et):
        e.uq_iters, e.uq_lr = iters, 1e-2
    return ej, et


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_gaussian_uq_matches_jax(seed):
    """The Adam on random sample sets, direct and from moments: measured
    rel 4e-7 at most; bound rtol 1e-5 (the start's moments differ in their
    last bits, and m / sqrt(v) passes them on)."""
    ej, et = _uq_engines()
    rng = np.random.default_rng(seed)
    rgbs = rng.uniform(0, 1, (16, 4, 3)).astype(np.float32)
    sigmas = rng.uniform(0, 5, (16, 4)).astype(np.float32)
    image = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    mu_j, sd_j = ej._gaussian_uq(jnp.asarray(rgbs), jnp.asarray(sigmas),
                                 jnp.asarray(image))
    mu_t, sd_t = et._gaussian_uq(torch.from_numpy(rgbs),
                                 torch.from_numpy(sigmas),
                                 torch.from_numpy(image))
    np.testing.assert_allclose(float(mu_t), float(mu_j), rtol=1e-5)
    np.testing.assert_allclose(float(sd_t), float(sd_j), rtol=1e-5)
    cd = rgbs * sigmas[..., None]
    mom = np.float32([np.sum(cd * cd), np.sum(cd), np.sum(sigmas),
                      np.sum(sigmas ** 2)])
    mu_j, sd_j = ej._gaussian_uq_from_moments(jnp.asarray(mom),
                                              jnp.asarray(image), 64.0)
    mu_t, sd_t = et._gaussian_uq_from_moments(torch.from_numpy(mom),
                                              torch.from_numpy(image), 64.0)
    np.testing.assert_allclose(float(mu_t), float(mu_j), rtol=1e-5)
    np.testing.assert_allclose(float(sd_t), float(sd_j), rtol=1e-5)


def test_gaussian_uq_degenerate_density():
    """A collapsed density (S_c2d2 ~ 0) returns the start, finite."""
    ej, et = _uq_engines(50)
    rgbs = np.full((16, 4, 3), 0.5, np.float32)
    sigmas = np.zeros((16, 4), np.float32)
    image = np.ones((16, 3), np.float32)
    mu_t, sd_t = et._gaussian_uq(torch.from_numpy(rgbs),
                                 torch.from_numpy(sigmas),
                                 torch.from_numpy(image))
    mu_j, sd_j = ej._gaussian_uq(jnp.asarray(rgbs), jnp.asarray(sigmas),
                                 jnp.asarray(image))
    assert float(mu_t) == float(mu_j) and float(sd_t) == float(sd_j) == 0.0
