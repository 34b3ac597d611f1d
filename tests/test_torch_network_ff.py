"""`--ff` in the port: `make_network`'s dispatch on the CLI's options and
`NeRFNetworkFF` (nerfsafetyvalidation_tpu_torch/models/network_ff.py)
against the JAX package's on the CPU.

The dispatch gives JAX's class, compute dtype and parameter shapes for
the default flags, `-O`, `--ff` and `-O --ff`, and builds JAX's class for
`--tcnn`. The FF net's `density`, `color` (its input
zero-padded to 32), forward and gradients are held to JAX's
`NeRFNetworkFF` (its K4 in interpret mode, the port's K4 plain version and
recomputed backward) on weights carried across; a JAX `--ff` checkpoint
loads into the port's net and the port's into JAX's."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu import cli as JCLI
from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.config import \
    network_config_from_opt as j_config_from_opt
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.train.checkpoint import \
    CheckpointManager as JCkpt
from nerfsafetyvalidation_tpu.train.trainer import Trainer as JTrainer
from nerfsafetyvalidation_tpu_torch import cli as TCLI
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.config import \
    network_config_from_opt as t_config_from_opt
from nerfsafetyvalidation_tpu_torch.models import NeRFNetworkFF
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.train import trainer as TT

torch.set_num_threads(1)

FF = types.SimpleNamespace(ff=True, tcnn=False)
NET = dict(encoding="hashgrid", bound=1.0, num_levels=4, level_dim=2,
           base_resolution=4, log2_hashmap_size=10, desired_resolution=32,
           hidden_dim=16, hidden_dim_color=16, fused=True, grid_size=16,
           compute_dtype="float32")


def _opts(argv):
    return (TCLI.apply_O_flag(TCLI.build_parser("train").parse_args(argv),
                              "train"),
            JCLI.apply_O_flag(JCLI.build_parser("train").parse_args(argv),
                              "train"))


@pytest.mark.parametrize("flags", [[], ["-O"], ["--ff"], ["-O", "--ff"]],
                         ids=["default", "O", "ff", "O_ff"])
def test_make_network_matches_jax(flags):
    """The same argv builds JAX's class, in its compute dtype, with its
    `fused`, and the parameters of JAX's init in shape and order (the full
    default widths: 16 levels x 2, 2^19 rows)."""
    opt_t, opt_j = _opts(["data", *flags])
    net_j = j_make(j_config_from_opt(opt_j), opt_j)
    net_t = t_make(t_config_from_opt(opt_t), None, device="cpu", opt=opt_t)
    assert type(net_t).__name__ == type(net_j).__name__
    assert net_t.cfg.compute_dtype == net_j.cfg.compute_dtype
    assert net_t.cfg.fused == net_j.cfg.fused
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    assert [tuple(w.shape) for w in net_t.param_list()] == \
        [tuple(s.shape) for s in TT.param_leaves(shapes)]
    if "--ff" in flags:
        assert net_t.cfg.compute_dtype == "bfloat16" and net_t.cfg.fused
        assert [tuple(w.shape) for w in net_t.param_list()[1:]] == [
            (32, 64), (64, 64), (64, 16),
            (32, 64), (64, 64), (64, 64), (64, 3)]


@pytest.mark.parametrize("flags", [["--tcnn"], ["-O", "--tcnn"]],
                         ids=["tcnn", "O_tcnn"])
def test_tcnn_raises(flags):
    """--tcnn builds `NeRFNetworkTCNN` in both packages (the port raised
    here before it had the net; the name stayed): JAX's compute dtype and
    `fused`, and its parameters (weight then bias a layer) in shape and
    order, at the CLI's default widths."""
    opt_t, opt_j = _opts(["data", *flags])
    net_j = j_make(j_config_from_opt(opt_j), opt_j)
    net_t = t_make(t_config_from_opt(opt_t), None, device="cpu", opt=opt_t)
    assert type(net_j).__name__ == type(net_t).__name__ == "NeRFNetworkTCNN"
    assert net_t.cfg.compute_dtype == net_j.cfg.compute_dtype
    assert net_t.cfg.fused and net_j.cfg.fused
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    assert [tuple(w.shape) for w in net_t.param_list()] == \
        [tuple(s.shape) for s in TT.param_leaves(shapes)]


def test_ff_refuses_what_jax_refuses():
    """A background net (JAX asserts) and a frequency encoding (JAX's
    apply then feeds the 32-wide color net to K1, which raises)."""
    with pytest.raises(AssertionError):
        NeRFNetworkFF(TConfig(**dict(NET, bg_radius=1.5)), device="cpu")
    with pytest.raises(AssertionError):
        j_make(JConfig(**dict(NET, bg_radius=1.5)), FF)
    with pytest.raises(NotImplementedError):
        NeRFNetworkFF(TConfig(**dict(NET, encoding="frequency")),
                      device="cpu")


def test_init_draws_the_ff_topology():
    """`init` draws the FFMLP shapes, each weight uniform in
    +-1/sqrt(in); one seed gives one net."""
    net = t_make(TConfig(**NET), None, device="cpu", opt=FF,
                 generator=torch.Generator().manual_seed(2))
    ws = net.param_list()[1:]
    assert [tuple(w.shape) for w in ws] == [
        (8, 16), (16, 16), (16, 16), (32, 16), (16, 16), (16, 16), (16, 3)]
    for w in ws:
        bound = 1.0 / np.sqrt(w.shape[0])
        assert 0.9 * bound < float(w.abs().max()) <= bound
    twin = t_make(TConfig(**NET), None, device="cpu", opt=FF,
                  generator=torch.Generator().manual_seed(2))
    assert all(torch.equal(a, b) for a, b in zip(net.param_list(),
                                                 twin.param_list()))


def _params(seed=3):
    net_j = j_make(JConfig(**NET), FF)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.5, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] *= 3.0
    p["sigma_net"][-1][:, 0] = np.abs(p["sigma_net"][-1][:, 0])
    return net_j, p


def _inputs(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, d


# bf16 on both sides: bounded at one bf16 step (2^-8) relative, so that an
# activation landing on the neighbouring bf16 value under another sum
# order still passes (as test_torch_network.py's bf16 hash-grid nets)
RTOL, ATOL = 2.0 ** -8, 1e-5


def test_density_color_and_forward_match_jax():
    net_j, p = _params()
    p_j = jax.tree_util.tree_map(jnp.asarray, p)
    net_t = t_make(TConfig(**NET), params_from_jax(p, device="cpu"),
                   device="cpu", opt=FF)
    assert net_t.cfg.compute_dtype == "bfloat16" == net_j.cfg.compute_dtype
    x, d = _inputs(1000)
    mask = np.random.default_rng(4).random(1000) < 0.8
    ref = net_j.density(p_j, jnp.asarray(x))
    geo = np.asarray(ref["geo_feat"]).astype(np.float32)
    c_j = net_j.color(p_j, None, jnp.asarray(d), geo_feat=ref["geo_feat"],
                      mask=jnp.asarray(mask))
    s_j, rgb_j = net_j.apply(p_j, jnp.asarray(x), jnp.asarray(d))
    with torch.inference_mode():
        got = net_t.density(torch.from_numpy(x))
        c_t = net_t.color(torch.from_numpy(d), torch.from_numpy(geo),
                          mask=torch.from_numpy(mask))
        s_t, rgb_t = net_t(torch.from_numpy(x), torch.from_numpy(d))
    sig_j = np.asarray(ref["sigma"])
    assert 10.0 * sig_j.min() < sig_j.max()
    for a, b in ((got["sigma"], sig_j), (got["geo_feat"], geo),
                 (c_t, np.asarray(c_j)), (s_t, np.asarray(s_j)),
                 (rgb_t, np.asarray(rgb_j))):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)
    assert (c_t.numpy()[~mask] == 0).all()


def test_gradients_match_jax_vjp():
    """d(sum(gs * sigma) + sum(gc * rgb)) / d(table, every weight) of the
    forward, against jax.vjp of JAX's `apply`. bf16 cotangents round where
    JAX's casts round them; bounded at 1e-2 of each tensor's largest
    gradient, the bound of K4's bf16 gradients (test_torch_k4_grad.py)."""
    net_j, p = _params(seed=5)
    x, d = _inputs(600, seed=2)
    rng = np.random.default_rng(6)
    gs = rng.normal(size=600).astype(np.float32)
    gc = rng.normal(size=(600, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda q: net_j.apply(q, jnp.asarray(x),
                                           jnp.asarray(d)),
                     jax.tree_util.tree_map(jnp.asarray, p))
    want = TT.param_leaves(vjp((jnp.asarray(gs), jnp.asarray(gc)))[0])
    net_t = t_make(TConfig(**NET), params_from_jax(p, device="cpu"),
                   device="cpu", opt=FF, trainable=True)
    s_t, rgb_t = net_t(torch.from_numpy(x), torch.from_numpy(d))
    got = torch.autograd.grad(
        (s_t * torch.from_numpy(gs)).sum()
        + (rgb_t * torch.from_numpy(gc)).sum(), net_t.param_list())
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        gap = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        assert gap <= 1e-2, gap


def test_x_gradient_matches_jax_vjp():
    """d(sum(gs * sigma)) / dx through the trilinear weights of the
    encode and the sigma net, against jax.vjp of JAX's `density`; bounded
    at 1e-2 of the largest, as the weights' gradients."""
    net_j, p = _params(seed=7)
    x, _ = _inputs(400, seed=3)
    gs = np.random.default_rng(8).normal(size=400).astype(np.float32)
    p_j = jax.tree_util.tree_map(jnp.asarray, p)
    _, vjp = jax.vjp(lambda a: net_j.density(p_j, a)["sigma"],
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(gs))[0])
    net_t = t_make(TConfig(**NET), params_from_jax(p, device="cpu"),
                   device="cpu", opt=FF)
    xt = torch.tensor(x, requires_grad=True)
    (got,) = torch.autograd.grad(
        (net_t.density(xt)["sigma"] * torch.from_numpy(gs)).sum(), xt)
    gap = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert gap <= 1e-2, gap


def _opt(**kw):
    return types.SimpleNamespace(**dict(dict(
        color_space="srgb", scale=0.8, offset=[0.1, 0, -0.2], bound=1.0,
        fp16=True, preload=True, rand_pose=-1, num_rays=128,
        error_map=False, lr=1e-2, iters=100, seed=0, ff=True, tcnn=False),
        **kw))


def test_jax_ff_checkpoint_loads_in_the_port(tmp_path):
    net_j, p = _params(seed=9)
    tr_j = JTrainer("ngp", _opt(), net_j, params=jax.tree_util.tree_map(
        jnp.asarray, p), workspace=str(tmp_path), use_checkpoint="scratch",
        mute=True, ema_decay=0.9)
    tr_j.epoch, tr_j.global_step = 2, 17
    tr_j.save_checkpoint(full=True)
    net_t = t_make(TConfig(**NET), None, device="cpu", opt=FF,
                   trainable=True)
    tr_t = TT.Trainer(_opt(), net_t, workspace=str(tmp_path), mute=True,
                      use_checkpoint="latest", ema_decay=0.9)
    assert isinstance(tr_t.net, NeRFNetworkFF)
    assert (tr_t.epoch, tr_t.global_step) == (2, 17)
    for a, b in zip(tr_t.net.param_list(), TT.param_leaves(p)):
        np.testing.assert_array_equal(a.detach().numpy(), b)


def test_port_ff_checkpoint_loads_in_jax(tmp_path):
    _, p = _params(seed=10)
    net_t = t_make(TConfig(**NET), params_from_jax(p, device="cpu"),
                   device="cpu", opt=FF, trainable=True)
    tr = TT.Trainer(_opt(), net_t, workspace=str(tmp_path), mute=True,
                    use_checkpoint="scratch")
    tr.epoch, tr.global_step = 1, 5
    state = JCkpt.load(tr.save_checkpoint(full=True))
    shapes = jax.eval_shape(j_make(JConfig(**NET), FF).init,
                            jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(state["model"]) == \
        jax.tree_util.tree_structure(shapes)
    for a, b in zip(jax.tree_util.tree_leaves(state["model"]),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), b)
