"""The port's mip-fold training route against the JAX package's, on the
CPU: `mip_fold_encode` without a fold table, per `train_gather` ("corner8",
"foldrow", "foldrow_pallas" through K5's plain versions against JAX's K5 in
interpret mode), values and gradients of the pyramid grids and the hash
table; `mip_fold_init`; and the trainable `NeRFNetworkMip` (its init, its
routes, and the stale fold table it refuses).

The spec is small (5 levels of 2 channels from base 4, dense up to 16,
hashed 32/64 into 2^10 rows), the weights drawn by numpy from a seed."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.ops import mip_encoding as J
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.ops import mip_encoding as T
from nerfsafetyvalidation_tpu_torch.ops.hopper import fold_build as K5

torch.set_num_threads(1)

SMALL = dict(pyramid_scales=(4, 8, 16), pyramid_channels=2,
             mip_scales=(32, 64), mip_channels=2, log2_hashmap_size=10)
NET = dict(encoding="mipfold", bound=1.0, num_levels=5, level_dim=2,
           base_resolution=4, fold_max_scale=16, log2_hashmap_size=10,
           grid_size=16, grid_ray=True)
GATHERS = ["corner8", "foldrow", "foldrow_pallas"]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    spec = J.MipFoldSpec(**SMALL)
    p = {"pyramid": [rng.normal(0, 0.5, ((s + 1) ** 3, 2)).astype(np.float32)
                     for s in SMALL["pyramid_scales"]],
         "hash": rng.normal(0, 0.5, (spec.hash_rows, spec.hash_width))
         .astype(np.float32)}
    x = rng.uniform(-1.05, 1.05, (3000, 3)).astype(np.float32)
    r = rng.normal(size=(3000, spec.output_dim)).astype(np.float32)
    return p, x, r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gather", GATHERS)
def test_encode_values_and_gradients_match_jax(case, gather, dtype):
    """Loss sum(enc * r) for a fixed cotangent r. Measured: the bf16
    encodings and every gradient (f32 and bf16) bit-exact; the f32
    encodings 2.4e-7 apart at most (XLA contracts the blend's products and
    sums into FMAs on the CPU). Bounds: gradients exact, f32 encodings
    1e-6."""
    p, x, r = case
    spec_j, spec_t = J.MipFoldSpec(**SMALL), T.MipFoldSpec(**SMALL)

    def loss_j(pp):
        e = J.mip_fold_encode(pp, jnp.asarray(x), spec_j,
                              compute_dtype=getattr(jnp, dtype),
                              train_gather=gather)
        return jnp.sum(e.astype(jnp.float32) * r), e

    (_, enc_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p))
    p_t = {"pyramid": [torch.tensor(a, requires_grad=True)
                       for a in p["pyramid"]],
           "hash": torch.tensor(p["hash"], requires_grad=True)}
    launches = K5.LAUNCHES
    enc_t = T.mip_fold_encode(p_t, torch.from_numpy(x), spec_t,
                              compute_dtype=getattr(torch, dtype),
                              train_gather=gather)
    (enc_t.float() * torch.from_numpy(r)).sum().backward()
    assert K5.LAUNCHES == launches            # CPU tensors: plain versions
    assert enc_t.dtype == getattr(torch, dtype)
    got = enc_t.detach().float().numpy()
    want = np.asarray(enc_j.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    for a, b in zip([*p_t["pyramid"], p_t["hash"]],
                    [*g_j["pyramid"], g_j["hash"]]):
        np.testing.assert_array_equal(a.grad.numpy(), np.asarray(b))


@pytest.mark.parametrize("gather", GATHERS)
def test_training_routes_equal_the_fold_table_route(case, gather):
    """Independent of JAX: every training route gives the inference
    route's values (f32: exact products, the same sums)."""
    p, x, _ = case
    spec = T.MipFoldSpec(**SMALL)
    pt = {k: (torch.from_numpy(v) if k == "hash"
              else [torch.from_numpy(g) for g in v]) for k, v in p.items()}
    fold = T.build_mip_fold_table(pt, spec, dtype=torch.float32)
    want = T.mip_fold_encode(pt, torch.from_numpy(x), spec, fold_table=fold)
    got = T.mip_fold_encode(pt, torch.from_numpy(x), spec,
                            train_gather=gather)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["pair", "quad", "cube"])
def test_unported_corner_fetches_raise(case, mode):
    """These corner fetches once raised NotImplementedError; they are
    ported now and must encode as "corner8" does: the same corner values
    (bit-exact), fetched as windows. Their JAX parity is in
    tests/test_torch_corner_fetch.py."""
    p, x, _ = case
    spec = T.MipFoldSpec(**SMALL)
    pt = {"pyramid": [torch.from_numpy(g) for g in p["pyramid"]],
          "hash": torch.from_numpy(p["hash"])}
    want = T.mip_fold_encode(pt, torch.from_numpy(x), spec,
                             train_gather="corner8")
    got = T.mip_fold_encode(pt, torch.from_numpy(x), spec,
                            train_gather=mode)
    assert torch.equal(got, want)


def test_mip_fold_init_range_and_order():
    spec = T.MipFoldSpec(**SMALL)
    a = T.mip_fold_init(torch.Generator().manual_seed(5), spec)
    b = T.mip_fold_init(torch.Generator().manual_seed(5), spec)
    shapes = [tuple(g.shape) for g in a["pyramid"]] + [tuple(a["hash"].shape)]
    assert shapes == [(125, 2), (729, 2), (4913, 2), (1024, 32)]
    for u, v in zip(a["pyramid"] + [a["hash"]], b["pyramid"] + [b["hash"]]):
        assert torch.equal(u, v)
        assert float(u.abs().max()) <= 1e-4 and float(u.std()) > 4e-5


def _tree(ws):
    """A list in param_list() order as the JAX pytree's leaves order."""
    pyr = ws[:3]
    tree = {"encoder": {"pyramid": pyr, "hash": ws[3]},
            "sigma_net": ws[4:6], "color_net": ws[6:]}
    return jax.tree_util.tree_leaves(tree)


def _nets(dtype="float32", gather="foldrow_pallas"):
    """The JAX net and its params, and the trainable port net holding the
    same params (the JAX init pytree carried over by params_from_jax)."""
    cfg_j = JConfig(**NET, compute_dtype=dtype, train_gather=gather)
    net_j = j_make(cfg_j)
    p_j = net_j.init(jax.random.PRNGKey(3))
    net_t = t_make(TConfig(**NET, compute_dtype=dtype, train_gather=gather),
                   params_from_jax(p_j, device="cpu"), device="cpu",
                   trainable=True)
    return net_j, p_j, net_t


def test_trainable_net_init_matches_jax_shapes_and_bounds():
    net_j, p_j, net_t = _nets()
    fresh = t_make(net_t.cfg, None, device="cpu", trainable=True,
                   generator=torch.Generator().manual_seed(1))
    leaves_j = jax.tree_util.tree_leaves(p_j)
    leaves_t = _tree(fresh.param_list())
    assert [tuple(w.shape) for w in leaves_t] == \
        [tuple(w.shape) for w in leaves_j]
    for wj, wt in zip(leaves_j, leaves_t):
        # same distribution: uniform in the same bounds
        bound = float(np.abs(np.asarray(wj)).max())
        assert wt.requires_grad
        assert float(wt.abs().max()) <= bound * 1.05 + 1e-9
        assert float(wt.abs().max()) >= bound * 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainable_net_gradients_match_jax(dtype):
    """Loss sum(rgb * r) + sum(sigma) through JAX `apply` (unfused) and the
    port's forward under autograd, from the same params. Measured: the
    loss 2.4e-6 relative (f32; it sums terms that cancel); f32 gradients
    2.7e-7 of each tensor's largest gradient at most; bf16 gradients equal
    on 98-100% of the entries and 3.2e-3 of the largest at most (a hidden
    activation rounds to the neighbouring bf16 value under another sum
    order). Bounds: loss 1e-5 relative; gradients 1e-5 (f32) and 2^-6
    (bf16) of each tensor's largest."""
    net_j, p_j, net_t = _nets(dtype)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    r = rng.normal(size=(512, 3)).astype(np.float32)

    def loss_j(p):
        s, c = net_j.apply(p, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(c * r) + 1e-3 * jnp.sum(s)

    l_j, g_j = jax.value_and_grad(loss_j)(p_j)
    s, c = net_t(torch.from_numpy(x), torch.from_numpy(d))
    l_t = (c * torch.from_numpy(r)).sum() + 1e-3 * s.sum()
    l_t.backward()
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-5)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    for gj, w in zip(jax.tree_util.tree_leaves(g_j),
                     _tree(net_t.param_list())):
        gj = np.asarray(gj)
        np.testing.assert_allclose(w.grad.numpy(), gj, rtol=0,
                                   atol=tol * max(np.abs(gj).max(), 1e-12))


def test_training_forward_never_reads_a_fold_table():
    """A fold table from to_folded() is read only without autograd, and
    only while the parameters are those it was built from."""
    _, _, net = _nets()
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (64, 3)).astype(np.float32))
    net.to_folded()
    with torch.no_grad():
        folded = net.encode_pos(x)
    enc = net.encode_pos(x)                   # autograd: the training route
    assert enc.requires_grad
    np.testing.assert_allclose(enc.detach().numpy(), folded.numpy(),
                               rtol=0, atol=1e-6)
    enc.sum().backward()
    assert all(g.grad is not None for g in net.pyramid)
    with torch.no_grad():
        net.pyramid[0].add_(1.0)              # what an optimizer step does
        with pytest.raises(RuntimeError, match="older parameters"):
            net.encode_pos(x)
        net.to_folded()
        net.encode_pos(x)


def test_fused_config_routes_the_trainable_net_through_k3(monkeypatch):
    import nerfsafetyvalidation_tpu_torch.models.network_mip as nm
    _, p_j, net = _nets()
    calls = []
    monkeypatch.setattr(nm, "fused_sigma_color",
                        lambda *a, **k: calls.append(1) or (None, None))
    x = torch.zeros((4, 3))
    d = torch.ones((4, 3)) / 3 ** 0.5
    net(x, d)                               # cfg.fused False: plain chain
    assert calls == []
    fused = t_make(replace(net.cfg, fused=True),
                   params_from_jax(p_j, device="cpu"), device="cpu")
    with pytest.raises(AttributeError):     # the spy returns no tensors
        fused.to_folded()(x, d)
    assert calls == [1]
