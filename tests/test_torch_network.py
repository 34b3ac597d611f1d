"""The full-width baked student (bench_assets/bench_student_h160x6.pkl)
through `NeRFNetwork` in both packages: the JAX `apply` with fused=True
(the Pallas points kernel, interpret mode on the CPU) against the port's
`forward` with fused=True (K1's plain version on the CPU), on 2,048 points.
The port loads the weights with its own loader, JAX with plain pickle."""

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
