"""`NeRFNetwork` in both packages on the CPU.

The full-width baked student (bench_assets/bench_student_h160x6.pkl): the
JAX `apply` with fused=True (the Pallas points kernel, interpret mode on
the CPU) against the port's `forward` with fused=True (K1's plain version
on the CPU), on 2,048 points. The port loads the weights with its own
loader, JAX with plain pickle.

The hash-grid field: `density` and `forward` at a small spec with weights
drawn by numpy, fused (JAX's K4 in interpret mode, K4's plain version in
the port) and unfused; and the reference backbone of
bench_assets/refbb.ckpt at full width."""

import pickle
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models.bake import student_config as j_student
from nerfsafetyvalidation_tpu.models.network import NeRFNetwork as JNet
from nerfsafetyvalidation_tpu_torch.assets import load_student, params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.models.bake import (
    student_config as t_student)

# one torch thread: MKL's threaded sin/cos is not exact under load
# (see test_torch_ops.py)
torch.set_num_threads(1)

STUDENT = Path(__file__).resolve().parents[1] / "bench_assets" / \
    "bench_student_h160x6.pkl"


def _inputs(n=2048):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, d


def _configs(dtype, fused=True):
    kw = dict(multires=12, hidden_dim=160, num_layers=6)
    j = j_student(JConfig(bound=1.0, compute_dtype=dtype, grid_size=128),
                  **kw)
    t = t_student(TConfig(bound=1.0, compute_dtype=dtype, grid_size=128),
                  **kw)
    return replace(j, fused=fused), replace(t, fused=fused)


@pytest.fixture(scope="module")
def params():
    with open(STUDENT, "rb") as f:
        p_j = jax.tree_util.tree_map(jnp.asarray, pickle.load(f)["params"])
    return p_j, params_from_jax(load_student(STUDENT), device="cpu")


def _apply_both(params, dtype):
    p_j, p_t = params
    cfg_j, cfg_t = _configs(dtype)
    x, d = _inputs()
    s_j, c_j = JNet(cfg_j).apply(p_j, jnp.asarray(x), jnp.asarray(d))
    with torch.inference_mode():
        s_t, c_t = make_network(cfg_t, p_t, device="cpu")(
            torch.from_numpy(x), torch.from_numpy(d))
    assert s_t.shape == (2048,) and c_t.shape == (2048, 3)
    return (s_t.numpy(), c_t.numpy()), (np.asarray(s_j), np.asarray(c_j))


def test_student_config_matches():
    cfg_j, cfg_t = _configs("bfloat16")
    for k in ("encoding", "multires", "num_layers", "hidden_dim",
              "hidden_dim_color", "num_layers_color", "geo_feat_dim",
              "bound", "min_near", "density_scale", "grid_size",
              "compute_dtype", "sh_degree", "fused"):
        assert getattr(cfg_t, k) == getattr(cfg_j, k), k
    assert cfg_t.cascade == cfg_j.cascade == 1


def test_full_width_apply_f32(params):
    (s_t, c_t), (s_j, c_j) = _apply_both(params, "float32")
    # the points kernel's cos is sin(t + pi/2), the plain chain's cos(t):
    # JAX's own kernel-vs-XLA tolerance (measured here: 2.2e-5 relative
    # on sigma, 3.6e-6 on rgb)
    np.testing.assert_allclose(s_t, s_j, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(c_t, c_j, rtol=5e-4, atol=1e-5)


def test_full_width_apply_bf16(params):
    (s_t, c_t), (s_j, c_j) = _apply_both(params, "bfloat16")
    # bf16 activations: a few of the 2,048 rows land an activation on the
    # neighbouring bf16 value (shifted-sine cos, other sum order) and that
    # carries through six layers. Measured: rgb 0.056 at most, 6.1e-5 on
    # average; sigma 0.0062 of max(|sigma|, 1) at most, 1.0e-5 on average.
    # Bounded at about 3x the maxima and 5-10x the means.
    rgb = np.abs(c_t - c_j)
    sig = np.abs(s_t - s_j) / np.maximum(np.abs(s_j), 1.0)
    assert rgb.max() <= 0.15 and rgb.mean() <= 5e-4, (rgb.max(), rgb.mean())
    assert sig.max() <= 0.02 and sig.mean() <= 1e-4, (sig.max(), sig.mean())


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4),
                                        ("bfloat16", 5e-3)])
def test_density_head(params, dtype, rtol):
    """The scout's density-only chain is plain in both packages; measured
    1.4e-5 (f32) and 6.8e-4 (bf16) of max(|sigma|, 1)."""
    p_j, p_t = params
    cfg_j, cfg_t = _configs(dtype, fused=False)
    x, _ = _inputs(1024)
    s_j = np.asarray(JNet(cfg_j).density(p_j, jnp.asarray(x))["sigma"])
    with torch.inference_mode():
        out = make_network(cfg_t, p_t, device="cpu").density(
            torch.from_numpy(x))
    assert out["geo_feat"].shape == (1024, 15)
    err = np.abs(out["sigma"].numpy() - s_j) / np.maximum(np.abs(s_j), 1.0)
    assert err.max() <= rtol, err.max()


def test_weights_must_match_the_config(params):
    """A student pkl of another width or depth is refused, not run."""
    _, p_t = params
    _, cfg_t = _configs("bfloat16")
    for bad in (replace(cfg_t, hidden_dim=192), replace(cfg_t, num_layers=5),
                replace(cfg_t, multires=10)):
        with pytest.raises(ValueError):
            make_network(bad, p_t, device="cpu")


# ---- the hash-grid field (the reference backbone's NeRFNetwork) ----------

GRID = dict(encoding="hashgrid", bound=1.0, num_levels=6, level_dim=2,
            base_resolution=4, log2_hashmap_size=10, desired_resolution=64,
            grid_size=32)


def _grid_params(cfg_j, seed=3):
    """The JAX pytree's shapes, filled by numpy: a table of features of
    order 1, and sigma's output lane biased up so that densities vary."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JNet(cfg_j).init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] *= 3.0
    p["sigma_net"][-1][:, 0] = np.abs(p["sigma_net"][-1][:, 0])
    return p


def _grid_both(p, dtype, fused, max_level=None, **kw):
    cfg = dict(GRID, **kw, compute_dtype=dtype, fused=fused,
               max_level=max_level)
    net_t = make_network(TConfig(**cfg), params_from_jax(p, device="cpu"),
                         device="cpu")
    return JNet(JConfig(**cfg)), jax.tree_util.tree_map(jnp.asarray, p), \
        net_t


def _grid_tol(dtype):
    # f32: the same operations in other sum orders (measured 3e-7
    # relative). bf16: bounded at one bf16 step (2^-8), so that an
    # encoding or activation that lands on the neighbouring bf16 value
    # under another sum order still passes
    return (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -8, 1e-5)


@pytest.mark.parametrize("max_level", [None, 4])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hashgrid_density_and_apply_match_jax(dtype, fused, max_level):
    """`density` and `forward` against the JAX `density` and `apply`, fused
    (JAX's K4 in interpret mode, the port's K4 plain version) and
    unfused."""
    p = _grid_params(JConfig(**GRID))
    net_j, p_j, net_t = _grid_both(p, dtype, fused, max_level)
    x, d = _inputs(1000)
    ref = net_j.density(p_j, jnp.asarray(x))
    s_j, c_j = net_j.apply(p_j, jnp.asarray(x), jnp.asarray(d))
    with torch.inference_mode():
        got = net_t.density(torch.from_numpy(x))
        s_t, c_t = net_t(torch.from_numpy(x), torch.from_numpy(d))
    rtol, atol = _grid_tol(dtype)
    sig_j = np.asarray(ref["sigma"])
    assert 10.0 * sig_j.min() < sig_j.max() < np.exp(15.0)
    np.testing.assert_allclose(got["sigma"].numpy(), sig_j, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(got["geo_feat"].numpy(),
                               np.asarray(ref["geo_feat"]).astype(np.float32),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=rtol,
                               atol=atol)
    if fused and dtype == "bfloat16":    # K4 rounds its last layer too
        g = got["geo_feat"].numpy()
        assert np.array_equal(torch.from_numpy(g).to(torch.bfloat16)
                              .float().numpy(), g)


def test_hashgrid_routes_through_k4(monkeypatch):
    """With cfg.fused, `forward` runs K4 twice (the sigma net, then the
    color net on [SH | geo] in bf16); `plain` runs K4's plain version."""
    import nerfsafetyvalidation_tpu_torch.models.network as tn
    p = _grid_params(JConfig(**GRID))
    *_, net_t = _grid_both(p, "bfloat16", True)
    calls = []
    for name in ("fused_mlp", "fused_mlp_plain"):
        real = getattr(tn, name)

        def spy(h, ws, dt, real=real, name=name):
            calls.append((name, tuple(h.shape), h.dtype))
            return real(h, ws, dt)

        monkeypatch.setattr(tn, name, spy)
    x, d = (torch.from_numpy(a) for a in _inputs(64))
    net_t(x, d)
    net_t(x, d, plain=True)
    assert calls == [("fused_mlp", (64, 12), torch.bfloat16),
                     ("fused_mlp", (64, 31), torch.bfloat16),
                     ("fused_mlp_plain", (64, 12), torch.bfloat16),
                     ("fused_mlp_plain", (64, 31), torch.bfloat16)]


@pytest.fixture(scope="module")
def refbb():
    """The committed reference backbone (bench_assets/refbb.ckpt) in both
    packages, JAX with plain pickle and bench.py's bf16 -> f32 upcast."""
    from nerfsafetyvalidation_tpu_torch import flagship as F
    nets, _ = F.load_ref_nets("cpu")
    with open(F.REF_CKPT, "rb") as f:
        model = pickle.load(f)["model"]
    p_j = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a).astype(np.float32)), model)
    return nets, p_j


@pytest.mark.parametrize("fused", [False, True])
def test_reference_backbone_full_width_matches_jax(refbb, fused):
    """bench.py's spec at full width (16 levels, 2^19 rows, 64-wide MLPs)
    with its trained weights, on 256 points. Measured: sigma 1.7e-6 of
    max(|sigma|, 1), rgb 9.1e-4 (one hidden activation on the neighbouring
    bf16 value); bounded at 2^-8 relative and 4e-3 absolute."""
    nets, p_j = refbb
    net_t = nets["ref"]
    cfg_j = JConfig(encoding="hashgrid", bound=1.0, compute_dtype="bfloat16",
                    density_thresh=10.0, fused=fused)
    if not fused:
        net_t = make_network(replace(net_t.cfg, fused=False),
                             {"encoder": {"embeddings": net_t.embeddings},
                              "sigma_net": list(net_t.sigma_net),
                              "color_net": list(net_t.color_net)},
                             device="cpu")
    x, d = _inputs(256)
    s_j, c_j = JNet(cfg_j).apply(p_j, jnp.asarray(x), jnp.asarray(d))
    with torch.inference_mode():
        s_t, c_t = net_t(torch.from_numpy(x), torch.from_numpy(d))
    s_j, c_j = np.asarray(s_j), np.asarray(c_j)
    assert s_j.max() > 100.0                         # a trained surface
    sig = np.abs(s_t.numpy() - s_j) / np.maximum(np.abs(s_j), 1.0)
    assert sig.max() <= 2.0 ** -8, sig.max()
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=0, atol=4e-3)


def test_hashgrid_weights_must_match_the_config():
    """A table or MLP of another shape is refused, not run; so are weights
    without the background net the config asks for (bg_radius > 0), and
    the aligned spec, which is not ported."""
    p = _grid_params(JConfig(**GRID))
    cfg = TConfig(**GRID)
    p_t = params_from_jax(p, device="cpu")
    make_network(cfg, p_t, device="cpu")
    for bad in (replace(cfg, log2_hashmap_size=9),
                replace(cfg, num_levels=5), replace(cfg, level_dim=4),
                replace(cfg, hidden_dim=32), replace(cfg, bg_radius=2.0)):
        with pytest.raises(ValueError):
            make_network(bad, p_t, device="cpu")
    with pytest.raises(NotImplementedError):
        make_network(replace(cfg, aligned_levels=True), p_t, device="cpu")
