"""The planner of the port (nerfsafetyvalidation_tpu_torch/nav/planner.py,
nav/astar.py with csrc/astar.cpp, data/rays.py `rays_for_pixels`,
validation/simulators/nerf_simulator.py `reset`) against the JAX package
on the CPU, from the same numpy-seeded inputs and weights:

  * `rays_for_pixels` bit-equal to JAX's and to the port's `get_rays`
    indexed at the pixels;
  * A*: the same path, cell for cell, as the JAX package's native A* on
    grids with many tied shortest paths, and the same errors;
  * `calc_everything` and `planner_cost_terms`: values and gradients in the
    knots against `jax.vjp`, per sim and over a population, through a
    float32 hash-grid `NeRFNetwork` and through `NeRFNetworkFF` (bf16, the
    port's K4 plain version against JAX's interpret-mode `fused_mlp`);
  * `a_star_init`: the knots bit-equal after the same numpy seed;
  * `NerfSimulator.reset`: the knots and actions after A* and a few
    epochs of `learn_init`, their pose and cost files, and the
    cache quirk (a second reset copies the cached files back and keeps
    the A* knots), in both packages.

JAX compiles the planner's epoch block once per knot count (module-scoped
fixtures keep the nets). Its eager ops compile one by one, seconds a
knot count, so its planner's `calc_everything` runs under `jax.jit` here
(a module fixture), as it does inside the epoch block; the reset's path
has the 6 knots of the update tests' plan, and the tests call JAX's
`get_full_states` under one jit."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.data import rays as JRays
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.nav import planner as JP
from nerfsafetyvalidation_tpu.nav.astar import astar as j_astar
from nerfsafetyvalidation_tpu.nav.camera import CannedCamera as JCanned
from nerfsafetyvalidation_tpu.native import lib as j_native
from nerfsafetyvalidation_tpu.validation.simulators import \
    NerfSimulator as JSim
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.data import rays as TRays
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.nav import planner as TP
from nerfsafetyvalidation_tpu_torch.nav.astar import astar as t_astar
from nerfsafetyvalidation_tpu_torch.nav.camera import CannedCamera as TCanned
from nerfsafetyvalidation_tpu_torch.validation.simulators import \
    NerfSimulator as TSim

torch.set_num_threads(1)

NET = dict(encoding="hashgrid", bound=1.0, num_levels=4, level_dim=2,
           base_resolution=4, log2_hashmap_size=10, desired_resolution=32,
           hidden_dim=16, hidden_dim_color=16, grid_size=16)
FF = type("Opt", (), {"ff": True, "tcnn": False})()
ROT = np.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                 np.float32)
PLANNER_CFG = {"T_final": 2.0, "steps": 8, "lr": 1e-3, "epochs_init": 6,
               "epochs_update": 2, "fade_out_epoch": 0,
               "fade_out_sharpness": 10, "exp_name": "ptest",
               "I": np.eye(3, dtype=np.float32), "g": 10.0, "mass": 1.0,
               "fixed_horizon": False,
               "body": np.asarray([[-0.05, 0.05], [-0.05, 0.05],
                                   [-0.02, 0.02]]),
               "nbins": [4, 4, 2]}


def _nets(ff=False, seed=3):
    """(JAX net, its params, the port's net) from numpy-drawn weights: the
    table N(0, 1.5), each weight N(0, 0.5), sigma's column positive."""
    opt = FF if ff else None
    cfg = dict(NET, fused=ff, compute_dtype="bfloat16" if ff else "float32")
    net_j = j_make(JConfig(**cfg), opt)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.5, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] *= 3.0
    p["sigma_net"][-1][:, 0] = np.abs(p["sigma_net"][-1][:, 0])
    net_t = t_make(TConfig(**cfg), params_from_jax(p, device="cpu"),
                   device="cpu", opt=opt)
    return net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


@pytest.fixture(scope="module", autouse=True)
def jax_calc_jitted():
    """JAX's planner module calls calc_everything through one jit (dt and
    mass static) for this module's tests."""
    orig = JP.calc_everything
    JP.calc_everything = jax.jit(orig, static_argnums=(4, 7))
    yield
    JP.calc_everything = orig


@pytest.fixture(scope="module")
def nets():
    return {"f32": _nets(), "ff": _nets(ff=True)}


def _density_fns(net_j, p_j, net_t, scale=1.0):
    """The validate CLI's density closure (the Blender -> NeRF rotation)
    in both packages, times `scale`."""
    rot_j, rot_t = jnp.asarray(ROT), torch.from_numpy(ROT)

    def dj(x):
        return scale * net_j.density(p_j, x.reshape((-1, 3)) @ rot_j)[
            "sigma"].reshape(x.shape[:-1])

    def dt(x):
        return scale * net_t.density(x.reshape(-1, 3) @ rot_t)[
            "sigma"].reshape(x.shape[:-1])
    return dj, dt


def _states(rng, lead=()):
    """Random [.., 18] start and end states (rotation matrices from
    rotation vectors) and knots [.., 6, 4]."""
    from nerfsafetyvalidation_tpu.nav.math_utils import vec_to_rot_matrix

    def state():
        pos = rng.uniform(-0.5, 0.5, lead + (3,))
        vel = rng.normal(0, 0.1, lead + (3,))
        rv = rng.normal(0, 0.2, lead + (3,))
        om = rng.normal(0, 0.1, lead + (3,))
        R = np.asarray(vec_to_rot_matrix(jnp.asarray(rv, jnp.float32)))
        return np.concatenate([pos, vel, R.reshape(lead + (9,)), om],
                              axis=-1).astype(np.float32)
    knots = np.concatenate([rng.uniform(-0.5, 0.5, lead + (6, 3)),
                            rng.normal(0, 0.3, lead + (6, 1))], axis=-1)
    ia = rng.uniform(9.0, 11.0, lead + (2,))
    return state(), state(), knots.astype(np.float32), ia.astype(np.float32)


CONST = dict(dt=2.0 / 8)


@jax.jit
def _calc_j(knots, ia, s, e):
    return JP.calc_everything(knots, ia, s, e, CONST["dt"],
                              jnp.asarray([0.0, 0.0, -10.0]), jnp.eye(3), 1.0)


def _calc_t(knots, ia, s, e):
    return TP.calc_everything(knots, ia, s, e, CONST["dt"],
                              torch.tensor([0.0, 0.0, -10.0]), torch.eye(3),
                              1.0)


# ------------------------------------------------------------------- rays
def test_rays_for_pixels_bit_equal():
    """The same bits as JAX's rays_for_pixels, and as the port's get_rays
    indexed at the pixels, on a rotated pose."""
    rng = np.random.default_rng(0)
    H, W = 24, 20
    intr = (21.0, 19.0, W / 2, H / 2)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    coords = np.stack([rng.integers(0, H, 50), rng.integers(0, W, 50)], -1)
    ro_j, rd_j = JRays.rays_for_pixels(jnp.asarray(pose), intr,
                                       jnp.asarray(coords))
    ro_t, rd_t = TRays.rays_for_pixels(torch.from_numpy(pose), intr,
                                       torch.from_numpy(coords))
    full = TRays.get_rays(pose[None], intr, H, W, device="cpu")
    flat = coords[:, 0] * W + coords[:, 1]
    assert np.array_equal(ro_t.numpy(), np.asarray(ro_j))
    assert np.array_equal(rd_t.numpy(), np.asarray(rd_j))
    assert torch.equal(rd_t, full["rays_d"][0, flat])
    assert torch.equal(ro_t, full["rays_o"][0, flat])


# --------------------------------------------------------------------- A*
@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native library, built by its own loader with its
    own flags into a file of this module's (the shared file may be
    mid-build in another test process)."""
    saved = (j_native._SO, j_native._lib, j_native._tried)
    j_native._SO = str(tmp_path_factory.mktemp("native") / "lib.so")
    j_native._lib, j_native._tried = None, False
    assert j_native.build(force=True) and j_native.available()
    yield j_native
    j_native._SO, j_native._lib, j_native._tried = saved


def _grids():
    """(occupied, start, goal): an empty grid (every monotone path ties),
    a wall with two gaps, and random 30% occupancy."""
    out = []
    free = np.zeros((9, 9, 9), bool)
    out.append((free, (0, 0, 0), (8, 8, 8)))
    out.append((free, (1, 7, 2), (6, 0, 5)))
    wall = np.zeros((12, 10, 8), bool)
    wall[5] = True
    wall[5, 2, 1] = wall[5, 8, 6] = False
    out.append((wall, (0, 0, 0), (11, 9, 7)))
    rng = np.random.default_rng(5)
    for k in range(4):
        occ = rng.random((14, 13, 12)) < 0.3
        s, g = (0, 0, 0), (13, 12, 11)
        occ[s] = occ[g] = False
        out.append((occ, s, g))
    return out


@pytest.mark.parametrize("case", range(7))
def test_astar_path_equals_jax_native(case, jax_native):
    """Cell for cell the JAX package's native A* (built with the same
    flags) where a path exists; ValueError from both where none does."""
    occ, s, g = _grids()[case]
    native = jax_native.astar(occ, s, g)
    if native is None:
        with pytest.raises(ValueError):
            t_astar(occ, s, g)
        with pytest.raises(ValueError):
            j_astar(occ, s, g)
        return
    path = t_astar(occ, s, g)
    assert path == [tuple(int(v) for v in c) for c in native]
    assert len(path) - 1 == sum(abs(a - b) for a, b in zip(s, g)) or \
        occ.any()


def test_astar_occupied_ends_raise(jax_native):
    occ = np.zeros((4, 4, 4), bool)
    occ[0, 0, 0] = True
    for args in ((occ, (0, 0, 0), (3, 3, 3)), (occ, (3, 3, 3), (0, 0, 0))):
        with pytest.raises(AssertionError):
            t_astar(*args)
        with pytest.raises(AssertionError):
            j_astar(*args)


# ------------------------------------------------------------ the planner
@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "population"])
def test_calc_everything_matches_jax(lead):
    """Every output of calc_everything, per sim and over a leading
    population dimension (each sim against JAX's call on it alone).
    float32 on both sides, the same formulas in other reduction orders:
    bound 2e-5 relative to each output's largest value (measured 1e-6)."""
    s, e, knots, ia = _states(np.random.default_rng(1), lead)
    got = _calc_t(torch.from_numpy(knots), torch.from_numpy(ia),
                  torch.from_numpy(s), torch.from_numpy(e))
    for idx in np.ndindex(*lead):
        ref = _calc_j(jnp.asarray(knots[idx]), jnp.asarray(ia[idx]),
                      jnp.asarray(s[idx]), jnp.asarray(e[idx]))
        for a, b in zip(got, ref):
            b = np.asarray(b)
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a[idx].numpy(), b, rtol=0,
                                       atol=2e-5 * scale)


def _cost_j(net_j, p_j, knots, ia, s, e, body, epoch=0, fade=0):
    """JAX's cost, mean and gradient, jitted. XLA's excess precision is
    off, so that its fused bf16 ops round each result, as the eager ops
    (and the port's K4 plain version) do."""
    dj, _ = _density_fns(net_j, p_j, None)

    def f(k, a):
        total, col = JP.planner_cost_terms(
            k, a, jnp.asarray(s), jnp.asarray(e), epoch, density_fn=dj,
            dt=CONST["dt"], g_vec=jnp.asarray([0.0, 0.0, -10.0]),
            J=jnp.eye(3), mass=1.0, robot_body=jnp.asarray(body),
            fade_out_epoch=fade, fade_out_sharpness=10.0)
        return jnp.mean(total), (total, col)
    args = (jnp.asarray(knots), jnp.asarray(ia))
    vg = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    (loss, (total, col)), grads = vg.lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)
    return total, col, grads


def _cost_t(net_t, knots, ia, s, e, body, epoch=0, fade=0):
    _, dt = _density_fns(None, None, net_t)
    k = torch.from_numpy(knots).requires_grad_(True)
    a = torch.from_numpy(ia).requires_grad_(True)
    total, col = TP.planner_cost_terms(
        k, a, torch.from_numpy(s), torch.from_numpy(e), epoch,
        density_fn=dt, dt=CONST["dt"], g_vec=torch.tensor([0.0, 0.0, -10.0]),
        J=torch.eye(3), mass=1.0, robot_body=torch.from_numpy(body),
        fade_out_epoch=fade, fade_out_sharpness=10.0)
    grads = torch.autograd.grad(total.mean(dim=-1).sum(), (k, a))
    return total.detach(), col.detach(), grads


# float32: values 1e-5 of the largest, gradients 1e-4 of the largest
# (the density's gradient sums the trilinear corners in other orders).
# bf16 through K4: sigma lands on the neighbouring bf16 value now and then
# (2^-8 relative), density^2 twice that; gradients through K4's recompute
# and the bf16 table, 2e-2 of the largest (test_torch_k4_grad.py's bound).
COST_TOL = {"f32": (1e-5, 1e-4), "ff": (2 ** -6, 2e-2)}


@pytest.mark.parametrize("kind", ["f32", "ff"])
@pytest.mark.parametrize("fade", [0, 4], ids=["no_fade", "fade"])
def test_planner_cost_and_gradient_match_jax(nets, kind, fade):
    """planner_cost_terms' total and collision terms and the gradient of
    the mean cost in the knots and initial accelerations, against
    jax.value_and_grad, through each net (the FF net's K4 plain version
    and recomputed backward against JAX's interpret-mode fused_mlp)."""
    net_j, p_j, net_t = nets[kind]
    s, e, knots, ia = _states(np.random.default_rng(2))
    body = np.asarray(TP.Planner(s, e, dict(PLANNER_CFG), None,
                                 device="cpu").robot_body)
    tj, cj, gj = _cost_j(net_j, p_j, knots, ia, s, e, body, 2, fade)
    tt, ct, gt = _cost_t(net_t, knots, ia, s, e, body, 2, fade)
    v_tol, g_tol = COST_TOL[kind]
    assert float(np.abs(np.asarray(cj)).max()) > 1.0
    for a, b in ((tt, tj), (ct, cj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=v_tol,
                                   atol=v_tol * float(np.abs(b).max()))
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=g_tol * float(np.abs(b).max()))


def test_planner_cost_population_equals_per_sim(nets):
    """A population of 3 sims in one call gives each sim's cost and
    gradient as its call alone (exact but for the density's row order)."""
    net_j, p_j, net_t = nets["f32"]
    s, e, knots, ia = _states(np.random.default_rng(3), (3,))
    body = np.asarray(TP.Planner(s[0], e[0], dict(PLANNER_CFG), None,
                                 device="cpu").robot_body)
    tt, ct, (gk, ga) = _cost_t(net_t, knots, ia, s, e, body)
    for i in range(3):
        t1, c1, (gk1, ga1) = _cost_t(net_t, knots[i], ia[i], s[i], e[i],
                                     body)
        torch.testing.assert_close(tt[i], t1, rtol=1e-6, atol=0)
        torch.testing.assert_close(gk[i], gk1, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ga[i], ga1, rtol=1e-5, atol=1e-5)


def _box_density(x, lib):
    """10 inside a box, 0 outside: thresholds at 0.3 the same way in both
    packages (comparisons of float32 coordinates)."""
    inside = (lib.abs(x[..., 0] - 0.05) < 0.35) & (x[..., 1] > -0.6) \
        & (x[..., 1] < 0.4) & (x[..., 2] < 0.3)
    return 10.0 * inside


def _bump(x, lib):
    """A smooth density under A*'s 0.3 everywhere (every cell free in both
    packages), whose gradient the planner's cost sees."""
    d2 = ((x - lib.asarray([0.1, -0.05, 0.15])) ** 2).sum(-1)
    return 0.25 * lib.exp(-d2 / 0.05)


def _planners(density_j, density_t, cfg=None):
    cfg = dict(PLANNER_CFG, **(cfg or {}))
    s = np.zeros(18, np.float32)
    e = np.zeros(18, np.float32)
    s[:3], e[:3] = [-0.7, -0.1, 0.1], [0.75, 0.2, 0.05]
    s[6:15] = e[6:15] = np.eye(3).reshape(-1)
    pj = JP.Planner(jnp.asarray(s), jnp.asarray(e), dict(cfg), density_j)
    pt = TP.Planner(s, e, dict(cfg), density_t, device="cpu")
    return pj, pt


def _full_states_j(p):
    """JAX's Planner.get_full_states of p, under one jit."""
    def full(states, ia):
        q = copy.copy(p)
        q.states, q.initial_accel = states, ia
        return q.get_full_states()
    return np.asarray(jax.jit(full)(p.states, p.initial_accel))


def test_a_star_init_knots_bit_equal(jax_native):
    """The same occupancy, path, numpy draws and float32 smoothing: the
    knots equal bit for bit after the same numpy seed; the path goes
    round the box."""
    pj, pt = _planners(lambda x: _box_density(x, jnp),
                       lambda x: _box_density(x, torch))
    np.random.seed(11)
    pj.a_star_init()
    np.random.seed(11)
    pt.a_star_init()
    assert pt.occupied.any() and not pt.occupied.all()
    assert np.array_equal(pt.states.numpy(), np.asarray(pj.states))
    assert pt.states.shape[0] > 16


def _sims(root):
    """Both packages' NerfSimulator on the same start, goal, density and
    SDF, each in its own directory under root."""
    dj = lambda x: _bump(x, jnp)                            # noqa: E731
    dt = lambda x: _bump(x, torch)                          # noqa: E731
    s = np.zeros(18, np.float32)
    e = np.zeros(18, np.float32)
    s[:3], e[:3] = [-0.5, -0.5, 0.1], [0.05, -0.5, 0.1]   # 6 A* cells
    s[6:15] = e[6:15] = np.eye(3).reshape(-1)
    agent_cfg = {"mass": 1.0, "g": 10.0, "I": np.eye(3).tolist(),
                 "path": "./sim_img_cache"}
    planner_cfg = dict(PLANNER_CFG, epochs_init=3)
    camera_cfg = {"res_x": 8, "res_y": 8, "trans": True, "mode": "RGBA"}
    filter_cfg = {"dil_iter": 2, "kernel_size": 3, "batch_size": 8,
                  "lrate": 1e-3, "N_iter": 2, "render_viz": False,
                  "show_rate": [20, 100], "sig0": np.eye(12),
                  "Q": np.eye(12)}
    sdf = np.ones((96, 92, 24), np.float32)

    def rays_j(pose):
        return JRays.get_rays(pose, (8.0, 8.0, 4.0, 4.0), 8, 8)

    def render_j(ro, rd):
        return JR.render(net_j, p_j, ro, rd, staged=False, num_steps=4,
                         upsample_steps=0)

    def render_t(ro, rd):
        return TR.render(net_t, ro, rd, staged=False, num_steps=4,
                         upsample_steps=0)
    net_j, p_j, net_t = _nets()
    (root / "jax").mkdir()
    (root / "torch").mkdir()
    sim_j = JSim(jnp.asarray(s), jnp.asarray(e), agent_cfg, dict(planner_cfg),
                 camera_cfg, filter_cfg, rays_j, render_j, {}, dj,
                 "Gaussian Approximation", net_j, p_j, 7,
                 camera=JCanned(res_x=8, res_y=8), sdf=sdf,
                 render_batch_fn=render_j)
    sim_t = TSim(s, e, agent_cfg, dict(planner_cfg), camera_cfg, filter_cfg,
                 None, render_t, {}, dt, "Gaussian Approximation", net_t, 7,
                 camera=TCanned(res_x=8, res_y=8), sdf=sdf,
                 render_batch_fn=render_t, device="cpu")
    return sim_j, sim_t


def test_reset_actions_and_cache_quirk(tmp_path, monkeypatch, capsys,
                                      jax_native):
    """reset: A* (bit-equal knots) and 3 epochs of learn_init, the same
    knots (Adam's steps are lr-sized whatever the gradient: 1e-5
    absolute) and actions (1e-5 of the largest); the initial plan cached,
    its epoch-0 cost file alike. A second reset
    finds paths/<exp>/init_poses/0.json, skips learn_init, copies the
    cached files back, and keeps the A* knots, in both packages."""
    sim_j, sim_t = _sims(tmp_path)
    out = {}
    for name, sim in (("jax", sim_j), ("torch", sim_t)):
        monkeypatch.chdir(tmp_path / name)
        sim.reset()
        first = (np.asarray(sim.traj.get_actions()),
                 np.asarray(sim.traj.states))
        assert "Caching posts & costs!" in capsys.readouterr().out
        assert sorted(os.listdir("cached/ptest/poses")) == ["0.json"]
        sim.reset()
        assert "Using cached posts & costs!" in capsys.readouterr().out
        assert sorted(os.listdir("paths/ptest/init_poses")) == ["0.json"]
        out[name] = first + (np.asarray(sim.traj.states),
                             np.asarray(sim.traj.get_actions()), sim.steps)
    for kind in ("poses", "costs"):
        names = [sorted(os.listdir(tmp_path / sub / f"cached/ptest/{kind}"))
                 for sub in ("jax", "torch")]
        assert names[0] == names[1] == ["0.json"]
    cj, ct = (json.loads((tmp_path / sub / "cached/ptest/costs/0.json")
                         .read_text()) for sub in ("jax", "torch"))
    assert cj.keys() == ct.keys()
    for k in cj:
        np.testing.assert_allclose(ct[k], cj[k], rtol=1e-5, atol=1e-4)
    a_j, learned_j, astar_j, _, steps_j = out["jax"]
    a_t, learned_t, astar_t, again_t, steps_t = out["torch"]
    assert steps_t == steps_j == a_t.shape[0] == astar_t.shape[0] + 3
    assert np.array_equal(astar_t, astar_j)
    assert np.abs(learned_t - astar_t).max() > 1e-4
    np.testing.assert_allclose(learned_t, learned_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(a_t, a_j, rtol=0,
                               atol=1e-5 * np.abs(a_j).max())
    assert again_t.shape == a_t.shape and not np.allclose(again_t, a_t)


@pytest.mark.parametrize("fixed", [False, True], ids=["drop", "fixed"])
def test_update_state_and_learn_update_match_jax(fixed, tmp_path):
    """update_state after a measurement (dropping the first knot, or with
    fixed_horizon shifting and repeating the last), initial_accel from the
    old plan's actions; then a 2-epoch learn_update and its replan files
    (`_time<iteration>` suffixes), over the smooth density. Bounds as for
    reset: 1e-5 absolute on the knots."""
    pj, pt = _planners(lambda x: 40.0 * _bump(x, jnp),
                       lambda x: 40.0 * _bump(x, torch),
                       {"fixed_horizon": fixed})
    pt.states = torch.from_numpy(np.asarray(pj.states).copy())
    measured = _full_states_j(pj)[1] + np.float32(1e-3)
    pj.update_state(jnp.asarray(measured))
    pt.update_state(torch.from_numpy(measured))
    assert pt.states.shape == pj.states.shape
    assert np.array_equal(pt.states.numpy(), np.asarray(pj.states))
    np.testing.assert_allclose(pt.initial_accel.numpy(),
                               np.asarray(pj.initial_accel), rtol=1e-6)
    for p, sub in ((pj, "jax"), (pt, "torch")):
        p.basefolder = str(tmp_path / sub)
        p.learn_update(3)
    np.testing.assert_allclose(pt.states.numpy(), np.asarray(pj.states),
                               rtol=0, atol=1e-5)
    for sub in ("jax", "torch"):
        assert os.listdir(tmp_path / sub / "replan_poses") == \
            ["0_time3.json"]
    np.testing.assert_allclose(pt.get_full_states().numpy(),
                               _full_states_j(pj), rtol=0, atol=1e-4)


def test_agent_step_matches_jax():
    """Agent.step: the disturbed dynamics, the camera pose it captures
    (rot_x(pi/2) @ R) and the body-frame pose it returns, against the JAX
    Agent's with the same canned camera (float32; 1e-6)."""
    from nerfsafetyvalidation_tpu.nav.agent import Agent as JAgent
    from nerfsafetyvalidation_tpu_torch.nav.agent import Agent as TAgent
    rng = np.random.default_rng(4)
    x0 = rng.normal(0, 0.2, 12).astype(np.float32)
    cfg = {"x0": x0, "dt": 0.2, "g": 10.0, "mass": 1.0,
           "I": np.eye(3).tolist()}
    cam = {"res_x": 4, "res_y": 4, "trans": True, "mode": "RGBA"}
    cj, ct = JCanned(res_x=4, res_y=4), TCanned(res_x=4, res_y=4)
    aj = JAgent(cfg, cam, camera=cj)
    at = TAgent(cfg, cam, camera=ct, device="cpu")
    for _ in range(2):
        action = rng.normal([10.0, 0, 0, 0], 0.5).astype(np.float32)
        noise = rng.normal(0, 0.01, 12).astype(np.float32)
        pose_j, state_j, _ = aj.step(action, noise=noise)
        pose_t, state_t, img = at.step(action, noise=noise)
        np.testing.assert_allclose(state_t, state_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(pose_t, pose_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ct.poses[-1], cj.poses[-1], rtol=0,
                                   atol=1e-6)
        assert img.shape == (4, 4, 3) and img.dtype == np.uint8
    assert len(at.states_history) == len(aj.states_history) == 3
