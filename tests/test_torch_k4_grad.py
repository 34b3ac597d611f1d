"""K4's backward in the port (ops/hopper/fused_mlp.py: `fused_mlp` is an
autograd Function whose backward is the VJP of `fused_mlp_reference`, the
JAX package's `_xla_mlp`) against `jax.vjp` of the JAX package's
`fused_mlp` (its Pallas kernel in interpret mode, as tests/test_fused_mlp.py
runs it; its `custom_vjp` recomputes `_xla_mlp`), for x and every weight,
on the hash-grid field's two nets; and the weight cache, which must give
the kernel a fresh image after an optimizer changes the weights in
place."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops.pallas import fused_mlp as J
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as K
from nerfsafetyvalidation_tpu_torch.ops.hopper._nvcc import weights_key

torch.set_num_threads(1)

NETS = {"sigma": [32, 64, 16], "color": [31, 64, 64, 3]}


def _chain(dims, rows=300, seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 1.5 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    x = rng.normal(0, 1.0, (rows, dims[0])).astype(np.float32)
    g = rng.normal(0, 1.0, (rows, dims[-1])).astype(np.float32)
    return x, ws, g


def _vjp_gap(net, dtype):
    """max |port grad - JAX grad| / max |JAX grad| for x and each weight,
    the cotangent fixed."""
    x, ws, g = _chain(NETS[net], seed=len(NETS[net]))
    _, vjp = jax.vjp(
        lambda a, w: J.fused_mlp(a, w, compute_dtype=getattr(jnp, dtype),
                                 interpret=True),
        jnp.asarray(x), [jnp.asarray(w) for w in ws])
    d_x, d_ws = vjp(jnp.asarray(g))
    want = [np.asarray(d_x)] + [np.asarray(d) for d in d_ws]
    leaves = [torch.tensor(a, requires_grad=True) for a in [x] + ws]
    out = K.fused_mlp(leaves[0], leaves[1:], getattr(torch, dtype))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return [float(np.abs(a.numpy() - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("net", sorted(NETS))
def test_gradients_match_jax_vjp_f32(net):
    """float32: the same products summed in another order. Measured
    3.3e-7 of the largest gradient at most; bounded at 2e-5, the bound of
    K1's and K2's f32 gradients (tests/test_torch_deep_mlp.py)."""
    assert max(_vjp_gap(net, "float32")) <= 2e-5


@pytest.mark.parametrize("net", sorted(NETS))
def test_gradients_match_jax_vjp_bf16(net):
    """bfloat16: the cotangents round to bf16 where JAX's casts round
    them, so only the sums' order can differ, and with it now and then a
    rounding to the neighbouring bf16 value. Measured: equal, bit for bit,
    on these inputs; bounded at 1e-2, the bound of K1's and K2's bf16
    gradients."""
    assert max(_vjp_gap(net, "bfloat16")) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_is_the_kernels_function(dtype):
    """The Function's forward on the CPU is the plain version (the last
    layer rounded to the compute dtype, as the kernel rounds it), with or
    without a gradient to record."""
    x, ws, _ = _chain(NETS["color"], rows=64)
    ws_t = [torch.tensor(w, requires_grad=True) for w in ws]
    out = K.fused_mlp(torch.from_numpy(x), ws_t, dtype)
    assert out.requires_grad
    assert torch.equal(out.detach(), K.fused_mlp_plain(torch.from_numpy(x),
                                                       ws_t, dtype).detach())


@pytest.mark.parametrize("foreach", [False, True])
def test_weight_cache_repacks_after_an_update(foreach):
    """An Adam step changes the weights in place (one tensor at a time,
    or with the multi-tensor kernels the card's Adam uses): each
    weight's version moves, so the cache key changes and the kernel's next
    image is packed from the new weights, in bf16 and in f32."""
    x, ws, g = _chain(NETS["color"], rows=32)
    ws_t = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws]
    opt = torch.optim.Adam(ws_t, lr=1e-2, foreach=foreach)
    before = weights_key(ws_t)
    widths, image = K._prepare(ws_t)
    _, image32 = K._prepare_f32(ws_t)
    K.fused_mlp(torch.from_numpy(x), ws_t).backward(torch.from_numpy(g))
    opt.step()
    assert weights_key(ws_t) != before
    _, fresh = K._prepare(ws_t)
    _, fresh32 = K._prepare_f32(ws_t)
    assert not torch.equal(fresh, image) and not torch.equal(fresh32,
                                                             image32)
    assert torch.equal(fresh, K._pack(ws_t)[1])
    assert torch.equal(fresh32, K._pack_f32(ws_t)[1])


def test_network_table_cache_follows_the_table():
    """A trainable hash-grid net casts its f32 table to bf16 at every call
    under autograd; without autograd it keeps one cast copy, made again
    after an update changes the table."""
    cfg = NetworkConfig(encoding="hashgrid", bound=1.0, num_levels=4,
                        level_dim=2, base_resolution=4, log2_hashmap_size=10,
                        desired_resolution=32, hidden_dim=16,
                        hidden_dim_color=16, compute_dtype="bfloat16",
                        fused=True)
    net = make_network(cfg, None, device="cpu", trainable=True)
    with torch.no_grad():
        t0 = net.table
        assert net.table is t0 and t0.dtype == torch.bfloat16
    assert net.table is not t0 and net.table.requires_grad
    opt = torch.optim.Adam(net.param_list(), lr=1e-2)
    x = torch.rand(64, 3) * 2 - 1
    net.density(x)["sigma"].sum().backward()
    opt.step()
    with torch.no_grad():
        t1 = net.table
        assert t1 is not t0
        assert torch.equal(t1, net.embeddings.to(torch.bfloat16))
