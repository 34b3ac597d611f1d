"""The port's Bayesian Laplace UQ (nerfsafetyvalidation_tpu_torch/uq/
bayesian_laplace.py, orchestrator.py) and the nets' sigma-net flatpack
against the JAX package's on the CPU.

  * the flatpack: a JAX `get_sigma_net_flat` vector and the port's are the
    same bits, both ways, for `NeRFNetwork` (float32 hash grid),
    `NeRFNetworkFF` (bf16, K4) and the mip-fold teacher (float32, the
    flatpack JAX's inherits from `NeRFNetwork`);
  * BayesianLaplace's log-prior, log-likelihood and gradient at one theta;
    `fit` (10 Adam steps, 2 perturbations, 32 points) with the JAX fit's
    own draws handed in: the posterior mean, and the covariance with the
    Levenberg-Marquardt stage cut to its first step in both packages (see
    ONE_LM below); the full fit's stats finite;
  * `uncertainty` online and offline on each package's own staged frames
    (tests/torch_sequential_nets.py), JAX's draws handed to the port, the
    LM stage cut to its first step."""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sequential_nets as S
from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.uq import bayesian_laplace as JBL
from nerfsafetyvalidation_tpu.uq import hessian as JH
from nerfsafetyvalidation_tpu.uq import orchestrator as JO
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.uq import bayesian_laplace as TBL
from nerfsafetyvalidation_tpu_torch.uq import hessian as TH
from nerfsafetyvalidation_tpu_torch.uq import orchestrator as TO

torch.set_num_threads(1)

LAPLACE = "Bayesian Laplace Approximation"
FF = types.SimpleNamespace(ff=True, tcnn=False)
# the FF net at test widths: 4 levels x 2 (8 inputs), 16 wide: theta 640
NET_FF = dict(encoding="hashgrid", bound=1.0, num_levels=4, level_dim=2,
              base_resolution=4, log2_hashmap_size=10, desired_resolution=32,
              hidden_dim=16, hidden_dim_color=16, fused=True, grid_size=16,
              compute_dtype="float32")
NET_MIP = dict(encoding="mipfold", bound=1.0, num_levels=5, level_dim=2,
               base_resolution=4, fold_max_scale=16, log2_hashmap_size=10,
               grid_size=16, grid_ray=True)


def _ff(seed=3):
    """(JAX NeRFNetworkFF, its params, the port's): weights N(0, 0.5), the
    table N(0, 0.05) (a larger table drives a random theta's sigma past
    float32, see ROADMAP Queue 3)."""
    net_j = j_make(JConfig(**NET_FF), FF)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.5, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] *= 0.1
    net_t = t_make(TConfig(**NET_FF), params_from_jax(p, device="cpu"),
                   device="cpu", opt=FF)
    return net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


def _mip(seed=4):
    """(JAX NeRFNetworkMip, its params, the port's, folded): weights N(0,
    0.3), the pyramid grids and hash table N(0, 0.05)."""
    net_j = j_make(JConfig(**NET_MIP))
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["encoder"] = jax.tree_util.tree_map(lambda a: a / 6, p["encoder"])
    net_t = t_make(TConfig(**NET_MIP), params_from_jax(p, device="cpu"),
                   device="cpu").to_folded()
    return net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


@pytest.fixture(scope="module")
def nets():
    return {"f32": S.nets(), "ff": _ff(), "mip": _mip()}


# ------------------------------------------------------------ the flatpack
@pytest.mark.parametrize("which", ["f32", "ff", "mip"])
def test_flatpack_bit_exact_both_ways(nets, which):
    net_j, p_j, net_t = nets[which]
    flat_j = np.asarray(net_j.get_sigma_net_flat(p_j))
    flat_t = net_t.get_sigma_net_flat()
    assert flat_t.dtype == torch.float32
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    theta = np.random.default_rng(1).normal(size=flat_j.shape).astype(
        np.float32)
    # a JAX vector into the port: the same weights as JAX's set
    want = net_j.set_sigma_net_flat(p_j, jnp.asarray(theta))["sigma_net"]
    got = net_t.set_sigma_net_flat(torch.from_numpy(theta))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the port's vector into JAX gives back the port's weights
    back = net_j.set_sigma_net_flat(p_j, jnp.asarray(flat_t.numpy()))
    for g, w in zip(net_t.sigma_net, back["sigma_net"]):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    # a leading axis: one sigma net per group
    stack = torch.from_numpy(np.stack([theta, 2 * theta]))
    for k, ws in enumerate(zip(*(w.unbind(0) for w in
                                 net_t.set_sigma_net_flat(stack)))):
        for g, w in zip(ws, net_t.set_sigma_net_flat(stack[k])):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="entries"):
        net_t.set_sigma_net_flat(torch.zeros(flat_j.size + 1))


def test_mip_teacher_has_no_flatpack():
    """The mip-fold teacher's sigma-net flatpack: a theta of the wrong
    size raises as on the other nets, the flatpack of the weights gives
    them back, and the Laplace UQ's `uncertainty` runs on the teacher to
    finite stats. (The name predates the flatpack.)"""
    net = t_make(TConfig(**NET_MIP), None, device="cpu", trainable=True,
                 generator=torch.Generator().manual_seed(1))
    flat = net.get_sigma_net_flat()
    assert flat.shape == (sum(w.numel() for w in net.sigma_net),)
    with pytest.raises(ValueError, match="entries"):
        net.set_sigma_net_flat(torch.zeros(flat.numel() + 1))
    for a, b in zip(net.set_sigma_net_flat(flat), net.sigma_net):
        assert torch.equal(a, b.detach())
    rays = torch.zeros((1, 4, 3))
    trace, rmv = TO.uncertainty(LAPLACE, rendered_output=(
        {"aggregated_density": torch.zeros(1, 4)}, rays, rays),
        net=net.to_folded(), lr=1e-2, H=2, W=2, laplace_fit_steps=5)
    assert np.isfinite(trace) and np.isfinite(rmv)


# ----------------------------------------------------------- the posterior
def _data(seed=5, n=32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
            rng.uniform(0, 2, n).astype(np.float32))


def _jax_draws(n_theta, x_shape, n_pert, seed=0):
    """The draws of JAX's fit from PRNGKey(seed) without subsampling:
    theta's init, then the perturbations' standard normals."""
    key = jax.random.PRNGKey(seed)
    key, s1 = jax.random.split(key)
    key, s2 = jax.random.split(key)
    return dict(theta_init=np.asarray(jax.random.normal(s1, (n_theta,))),
                perturbations=np.asarray(jax.random.normal(
                    s2, (n_pert,) + tuple(x_shape))))


@pytest.mark.parametrize("which", ["f32", "ff", "mip"])
def test_posterior_terms_match_jax(nets, which):
    """log-prior, log-likelihood and the -log posterior's gradient at one
    random theta: the log terms within 1e-6 relative (float32 sums), the
    gradient within 1e-5 of its largest entry (bf16 K4 on the FF net:
    one bf16 rounding of a layer output flips now and then)."""
    net_j, p_j, net_t = nets[which]
    X, y = _data()
    n = net_t.get_sigma_net_flat().shape[0]
    theta = np.random.default_rng(2).normal(size=n).astype(np.float32)
    jb = JBL.BayesianLaplace(net_j, p_j, 0.0, 1.0, 1e-2)
    tb = TBL.BayesianLaplace(net_t, 0.0, 1.0, 1e-2)
    tt = torch.from_numpy(theta)
    args_j = (jnp.asarray(theta), jnp.asarray(X), jnp.asarray(y))
    args_t = (tt, torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(float(tb.log_prior(tt)),
                               float(jb.log_prior(args_j[0])), rtol=1e-6)
    np.testing.assert_allclose(float(tb.log_likelihood(*args_t)),
                               float(jb.log_likelihood(*args_j)), rtol=1e-6)
    want = np.asarray(jax.grad(lambda t: jb.negative_log_posterior(
        t, *args_j[1:]))(args_j[0]))
    leaf = tt.clone().requires_grad_(True)
    got = torch.autograd.grad(tb.negative_log_posterior(leaf, *args_t[1:]),
                              leaf)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ONE_LM: the fit's LM stage solves g g^T + lmbda I densely in float32 for
# 200 steps with lmbda falling tenfold on every improvement: the solves are
# ill-conditioned by |g|^2 / lmbda, and the two packages' iterates part at
# float32 noise (tests/test_torch_hessian.py) and then anywhere (one JAX
# image's trace came out 88.0 where the port's was 99.92). So the parity
# tests cut the stage to one step in both packages: its g g^T is then g
# at the MAP theta, and the trace and rmv are held within 1e-5 relative
# (float32 sums of the covariance's diagonal).
STATS_RTOL = 1e-5


def _one_lm_step(monkeypatch):
    for mod in (JH, TH):
        monkeypatch.setattr(mod, "levenberg_marquardt", functools.partial(
            mod.levenberg_marquardt, max_iter=1))


def _fits(nets, which, X, y):
    net_j, p_j, net_t = nets[which]
    n = net_t.get_sigma_net_flat().shape[0]
    kw = dict(num_perturbations=2, fit_steps=10)
    jb = JBL.BayesianLaplace(net_j, p_j, 0.0, 1.0, 1e-2, **kw).fit(X, y)
    tb = TBL.BayesianLaplace(net_t, 0.0, 1.0, 1e-2, draws=_jax_draws(
        n, X.shape, 2), **kw).fit(X, y)
    return jb, tb


# posterior mean, max |port - JAX| and the share within 1e-4: f32 net 1e-5
# and all (10 Adam steps of lr 1e-2 on gradients equal up to float32
# roundings); FF net: its bf16 K4 outputs flip to the neighbouring bf16
# value now and then, and Adam's normalised step turns a flipped
# near-zero gradient into a step of about lr the other way: measured
# 2.3e-2 at most, 88.6% of the 640 entries within 1e-4; bounds 2 lr a
# step (0.2) and 85%
MEAN_TOL = {"f32": (1e-5, 1.0), "ff": (0.2, 0.85)}


@pytest.mark.parametrize("which", ["f32", "ff"])
def test_fit_matches_jax(nets, which, monkeypatch):
    _one_lm_step(monkeypatch)
    X, y = _data()
    jb, tb = _fits(nets, which, X, y)
    mean_j = np.asarray(jb.get_posterior_mean())
    mean_t = tb.get_posterior_mean().numpy()
    gap = np.abs(mean_t - mean_j)
    bound, share = MEAN_TOL[which]
    assert gap.max() <= bound and (gap <= 1e-4).mean() >= share, \
        (gap.max(), (gap <= 1e-4).mean())
    cov_j = np.asarray(jb.get_posterior_cov())
    cov_t = tb.get_posterior_cov()
    assert cov_t.dtype == torch.float32 and cov_t.shape == cov_j.shape
    if which == "f32":
        # g at the same MAP theta: (g g^T + 1e-2 I)^-1 within 1e-4 of its
        # largest entry (100)
        np.testing.assert_allclose(cov_t.numpy(), cov_j, rtol=0,
                                   atol=1e-4 * np.abs(cov_j).max())


def test_full_fit_stats_finite(nets):
    """The full fit (LM's 200 steps, not compared: see ONE_LM) on the
    float32 net: finite trace and rmv, the covariance's diagonal clamped at
    0 in place by the stats, as JAX's."""
    X, y = _data()
    tb = _fits(nets, "f32", X, y)[1]
    trace, rmv = TO._posterior_stats(tb)
    assert np.isfinite(trace) and np.isfinite(rmv) and 0 < trace <= 100.0
    assert float(tb.get_posterior_cov().diagonal().min()) >= 0.0


# ----------------------------------------------------------- uncertainty()
@pytest.fixture(scope="module")
def frame_fns(nets):
    net_j, p_j, net_t = nets["f32"]
    return S.jax_fns(net_j, p_j), S.port_fns(net_t)


def _hand_in_jax_draws(monkeypatch, n_theta, n_points):
    """Each port fit gets the draws of a JAX fit seeded 0 on n_points."""
    draws = _jax_draws(n_theta, (n_points, 3), 3)
    monkeypatch.setattr(TO, "BayesianLaplace", functools.partial(
        TBL.BayesianLaplace, draws=draws))


def test_online_uncertainty_matches_jax(nets, frame_fns, monkeypatch,
                                        capsys):
    """`uncertainty` online on each package's staged frame of POSE (its
    rays and aggregated density), 5 Adam steps a copy, ONE_LM: (trace,
    rmv) at STATS_RTOL, printed once each."""
    _one_lm_step(monkeypatch)
    net_j, p_j, net_t = nets["f32"]
    jf, tf = frame_fns
    pose = np.float32([[0, 0, 1, -2.0], [1, 0, 0, 0.0], [0, 1, 0, 0.0],
                       [0, 0, 0, 1]])
    rj = jf["get_rays_fn"](jnp.asarray(pose)[None])
    oj = jf["render_fn"](rj["rays_o"], rj["rays_d"])
    rt = tf["get_rays_fn"](torch.from_numpy(pose)[None])
    with torch.no_grad():
        ot = tf["render_fn"](rt["rays_o"], rt["rays_d"])
    kw = dict(H=S.RES, W=S.RES, lr=1e-3, laplace_fit_steps=5)
    want = JO.uncertainty(LAPLACE, rendered_output=(oj, rj["rays_o"],
                                                    rj["rays_d"]),
                          net=net_j, params=p_j, **kw)
    _hand_in_jax_draws(monkeypatch, net_t.get_sigma_net_flat().shape[0],
                       S.RES * S.RES)
    got = TO.uncertainty(LAPLACE, rendered_output=(ot, rt["rays_o"],
                                                   rt["rays_d"]),
                         net=net_t, **kw)
    np.testing.assert_allclose(got, want, rtol=STATS_RTOL)
    assert capsys.readouterr().out.count("trace = ") == 2
    # the net's own sigma net is untouched
    np.testing.assert_array_equal(net_t.get_sigma_net_flat().numpy(),
                                  np.asarray(net_j.get_sigma_net_flat(p_j)))


def test_offline_uncertainty_matches_jax(nets, frame_fns, tmp_path,
                                         monkeypatch, capsys):
    """The offline sweep over a training directory of 2 images, ONE_LM:
    each image's (trace, rmv) at STATS_RTOL of JAX's, and the heat map
    written."""
    _one_lm_step(monkeypatch)
    net_j, p_j, net_t = nets["f32"]
    monkeypatch.chdir(tmp_path)
    os.makedirs("data/train")
    frames = []
    for k in range(2):
        pose = np.eye(4)
        pose[:3, :3] = [[0, 0, 1], [1, 0, 0], [0, 1, 0]]
        pose[0, 3], pose[1, 3] = -2.0, 0.1 * k
        frames.append({"file_path": f"./train/img{k}",
                       "transform_matrix": pose.tolist()})
        open(f"data/train/img{k}.png", "wb").close()
    with open("data/transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    jf, tf = frame_fns
    kw = dict(path_to_images="data/train", dataset_path="data", H=S.RES,
              W=S.RES, lr=1e-3, laplace_fit_steps=5)
    want = JO.uncertainty(LAPLACE, net=net_j, params=p_j,
                          render_fn=jf["render_fn"],
                          get_rays_fn=jf["get_rays_fn"], **kw)
    capsys.readouterr()
    os.remove("results/uncertainty_heatmap.png")
    _hand_in_jax_draws(monkeypatch, net_t.get_sigma_net_flat().shape[0],
                       S.RES * S.RES)
    got = TO.uncertainty(LAPLACE, net=net_t, render_fn=tf["render_fn"],
                         get_rays_fn=tf["get_rays_fn"], **kw)
    assert sorted(got) == ["rmv", "trace"] and len(got["trace"]) == 2
    for key in ("trace", "rmv"):
        np.testing.assert_allclose(got[key], want[key], rtol=STATS_RTOL)
    assert capsys.readouterr().out.count("Image #") == 2
    assert os.path.exists("results/uncertainty_heatmap.png")


# ------------------------------------------------------ the uncertain CLI
@pytest.mark.parametrize("flags", [[], ["-O"], ["-O", "--ff"]],
                         ids=["default", "O", "O_ff"])
def test_uncertain_parser_matches_jax(flags):
    from nerfsafetyvalidation_tpu import cli as JCLI
    from nerfsafetyvalidation_tpu_torch import cli as TCLI
    argv = ["data", "--seed", "0", *flags]
    want = vars(JCLI.apply_O_flag(JCLI.build_parser("uncertain").parse_args(
        argv), "uncertain"))
    got = vars(TCLI.apply_O_flag(TCLI.build_parser("uncertain").parse_args(
        argv), "uncertain"))
    assert got == want


@pytest.mark.parametrize("method", ["Gaussian Approximation", LAPLACE])
def test_uncertain_main_runs(method, tmp_path, monkeypatch, capsys):
    """`uncertain.main` as a user runs it, on a 16^2 dataset (2 training
    images) and a checkpoint of the CLI's hash-grid net: the staged
    render of each training pose, the UQ of envConfig's uq_method, one
    line an image, the heat map. The Laplace fits cut to 2 Adam steps and
    one LM step (the CPU's dense solves of the 3,072-entry theta)."""
    from nerfsafetyvalidation_tpu_torch import uncertain as U
    from nerfsafetyvalidation_tpu_torch.cli import apply_O_flag, \
        build_parser
    from nerfsafetyvalidation_tpu_torch.config import network_config_from_opt
    from nerfsafetyvalidation_tpu_torch.data.synthetic import (
        generate_dataset, write_dataset)
    from nerfsafetyvalidation_tpu_torch.train.checkpoint import \
        CheckpointManager
    monkeypatch.chdir(tmp_path)
    write_dataset("data", generate_dataset(n_train=2, n_val=1, n_test=1,
                                           H=16, W=16), split_dirs=True)
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "envConfig.json")) as f:
        env = json.load(f)
    env["uq_method"] = method
    with open("envConfig.json", "w") as f:
        json.dump(env, f)
    argv = ["data", "--workspace", "ws", "--bound", "1", "--scale", "1",
            "--num_steps", "8", "--upsample_steps", "0", "--seed", "0"]
    opt = apply_O_flag(build_parser("uncertain").parse_args(argv),
                       "uncertain")
    net = t_make(network_config_from_opt(opt), None, device="cpu", opt=opt)
    CheckpointManager("ws/checkpoints").save(1, 1, net.params_tree())
    _one_lm_step(monkeypatch)
    monkeypatch.setattr(U, "uncertainty", functools.partial(
        TO.uncertainty, laplace_fit_steps=2))
    res = U.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert out.count("Image #") == 2
    assert "End of uncertainty computation" in out
    key = "trace" if method == LAPLACE else "optimized_mu_d"
    assert key in res
    if method == LAPLACE:
        assert len(res["trace"]) == 2 and np.isfinite(res["trace"]).all()
        assert os.path.exists("results/uncertainty_heatmap.png")
