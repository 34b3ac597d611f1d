"""The trained flagship teacher of bench_assets/flagship.ckpt in both
packages, on the CPU: the port loads it with its own loader
(`flagship.load_teacher_net`), JAX with plain pickle and bench.py's
bfloat16 -> float32 upcast, both with bench.py's configuration (8 levels of
4 channels, dense to 128, 2^19 hash rows, bf16). JAX encodes through the
port's 512 MiB fold table (building its own would take most of a minute of
CPU; the fold build is held against JAX's in test_torch_mip_encoding.py):
the encoding of 2,048 points must be bit-exact, the field close."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu_torch import flagship as F

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def teachers():
    net_t, _ = F.load_teacher_net("cpu")
    with open(F.CKPT, "rb") as f:
        model = pickle.load(f)["model"]
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a).astype(np.float32)), model)
    cfg = JConfig(encoding="mipfold", bound=1.0, compute_dtype="bfloat16",
                  num_levels=8, level_dim=4, base_resolution=16,
                  fold_max_scale=128, grid_ray=True, density_thresh=10.0)
    net_j = j_make(cfg)
    params["encoder"]["fold_table"] = jnp.asarray(
        net_t.fold_table.float().numpy()).astype(jnp.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return net_t, net_j, params, x, d


def test_encoding_bit_exact(teachers):
    net_t, net_j, fp_j, x, _ = teachers
    assert tuple(net_t.fold_table.shape) == (128 ** 3, 128)
    assert net_t.fold_table.dtype == torch.bfloat16
    enc_j = np.asarray(net_j.encode_pos(fp_j, jnp.asarray(x)))
    enc_t = net_t.encode_pos(torch.from_numpy(x))
    np.testing.assert_array_equal(enc_t.float().numpy(),
                                  enc_j.astype(np.float32))


def test_field_matches_jax(teachers):
    """JAX's unfused chain (its fused chain is held at a small spec in
    test_torch_sigma_color.py). Measured: sigma 1.1e-7 relative, rgb
    6e-8; bounded at one bf16 step, 2^-8 relative."""
    net_t, net_j, fp_j, x, d = teachers
    s_j, c_j = net_j.apply(fp_j, jnp.asarray(x), jnp.asarray(d))
    s_t, c_t = net_t(torch.from_numpy(x), torch.from_numpy(d))
    assert float(np.asarray(s_j).max()) > 100.0       # a trained surface
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2.0 ** -8,
                               atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=2.0 ** -8,
                               atol=1e-5)
    dens_j = net_j.density(fp_j, jnp.asarray(x))["sigma"]
    dens_t = net_t.density(torch.from_numpy(x))["sigma"]
    np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j),
                               rtol=2.0 ** -8, atol=1e-5)
