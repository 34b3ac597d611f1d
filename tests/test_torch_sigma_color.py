"""Kernel K3 of the port (ops/hopper/sigma_color.py) and the teacher field
that runs it (models/network_mip.py), against the JAX package on the CPU.

K3's plain version is held against the JAX Pallas kernel
`fused_sigma_color`, run in interpret mode on the CPU as
tests/test_fused_mlp.py runs it, and against its XLA reference
`_xla_ref`. `NeRFNetworkMip` is held against the JAX `NeRFNetworkMip` at a
small mip spec, fused and unfused, with weights drawn by numpy and carried
into the port by `assets.params_from_jax`."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.ops.pallas import render_mlp as j_mlp
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.ops.hopper import sigma_color as sc

torch.set_num_threads(1)

NET = dict(encoding="mipfold", bound=1.0, num_levels=5, level_dim=2,
           base_resolution=4, fold_max_scale=16, log2_hashmap_size=10,
           grid_size=32)


def _chain(seed=0, rows=300, enc_dim=32):
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return rng.normal(0, 0.2, (i, o)).astype(np.float32)

    sn = [mat(enc_dim, 64), mat(64, 16)]
    cn = [mat(31, 64), mat(64, 64), mat(64, 3)]
    enc = rng.normal(0, 0.5, (rows, enc_dim)).astype(np.float32)
    sh = rng.normal(0, 0.5, (rows, 16)).astype(np.float32)
    return enc, sh, sn, cn


def _torch(*arrays):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray)
            else [torch.from_numpy(w) for w in a] for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) if isinstance(a, np.ndarray)
            else [jnp.asarray(w) for w in a] for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(dtype):
    enc, sh, sn, cn = _chain()
    s_j, c_j = j_mlp.fused_sigma_color(*_jax(enc, sh, sn, cn),
                                       compute_dtype=getattr(jnp, dtype))
    s_t, c_t = sc.fused_sigma_color(*_torch(enc, sh, sn, cn),
                                    compute_dtype=getattr(torch, dtype))
    if dtype == "float32":
        # JAX's own kernel-vs-XLA tolerance (test_fused_mlp.py)
        rtol, atol = 1e-5, 1e-6
    else:
        # bf16 operands: where the sum order lands an activation on the
        # neighbouring bf16 value (relative step 2^-8), the outputs move
        # by a fraction of that step; bounded at the step itself
        rtol, atol = 2.0 ** -8, 1e-5
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_xla_ref(dtype):
    enc, sh, sn, cn = _chain(seed=1, rows=257)
    s_j, c_j = j_mlp._xla_ref(*_jax(enc, sh), tuple(_jax(sn)[0]),
                              tuple(_jax(cn)[0]), getattr(jnp, dtype))
    s_t, c_t = sc.fused_sigma_color_plain(*_torch(enc, sh, sn, cn),
                                          getattr(torch, dtype))
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -8   # as above
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=rtol,
                               atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=rtol,
                               atol=1e-5)


def test_prepared_operands_match_tpu_layout():
    """The six matrices behind the kernel's image are the TPU kernel's
    `_prep_mats`, bit for bit; the image is built once per set of
    weights."""
    _, _, sn, cn = _chain()
    sn_t, cn_t = _torch(sn, cn)
    prep = sc._prepare(sn_t, cn_t)
    w1, w2, c1s, c1g, c2, c3 = prep["mats"]
    ref = j_mlp._prep_mats(tuple(_jax(sn)[0]), tuple(_jax(cn)[0]), 16,
                           jnp.bfloat16)
    for got, want in zip((w1, w2, c1s, c1g, c2, c3), ref):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))
    assert tuple(c3.shape) == (64, sc.LAST_COLS) and not c1g[0].any()
    assert prep["image"].numel() * 2 == sc.WEIGHT_BYTES == 20480
    assert sc._prepare(sn_t, cn_t)["image"] is prep["image"]  # built once
    with pytest.raises(ValueError):
        sc._prepare(_torch([sn[0][:30], sn[1]])[0], cn_t)
    with torch.inference_mode():       # weights made in inference mode
        sn_i, cn_i = _torch(sn, cn)
        assert len(sc._prepare(sn_i, cn_i)["mats"]) == 6


def _b_address(k, n, cols):
    """Element offset of B[k, n] in one matrix's wgmma image of `cols`
    columns, as the kernel's descriptor states the layout (csrc/sm90.cuh
    b_desc: K-major, no swizzle): 16-deep k-steps one after another,
    8-column groups 256 bytes apart, the two 8-deep halves of a k-step 128
    bytes apart, 8 x 8 core matrices of 16-byte rows (one column, 8
    depths)."""
    return ((k // 16) * 16 * cols + (n // 8) * 128 + ((k % 16) // 8) * 64
            + (n % 8) * 8 + k % 8)


def test_wgmma_image_gives_back_every_padded_weight():
    """The image read back through the descriptor's address function gives
    W1, W2, C1s, C1g (its zero row 0 included) and C2 bit for bit, C3 with
    zeros in its columns past rgb, at the kernel's offsets
    (csrc/sigma_color.cu kOffW1 .. kOffC3), and nothing else."""
    _, _, sn, cn = _chain(seed=5)
    prep = sc._prepare(*_torch(sn, cn))
    bits = prep["image"].view(torch.int16)
    w1, w2, c1s, c1g, c2, c3 = prep["mats"]
    c3_16 = torch.zeros((64, 16), dtype=torch.bfloat16)
    c3_16[:, :8] = c3
    offsets = [0, 2048, 3072, 4096, 5120, 9216]     # bf16 elements
    off = 0
    for m, want_off, shape in zip((w1, w2, c1s, c1g, c2, c3_16), offsets,
                                  sc.IMAGE_SHAPES):
        assert tuple(m.shape) == shape and off == want_off
        k, n = torch.meshgrid(torch.arange(shape[0]), torch.arange(shape[1]),
                              indexing="ij")
        assert torch.equal(bits[off + _b_address(k, n, shape[1])],
                           m.contiguous().view(torch.int16))
        off += shape[0] * shape[1]
    assert off == bits.numel()
    assert not c3_16[:, 3:].any() and not c1g[0].any()


def test_shared_memory_plan_fits_a_block():
    """Barriers (a full and an empty mbarrier a stage and the weights'),
    the 20,480-byte image and the ring fit the 232,448 bytes a block may
    use, every stage starts on a 128-byte boundary, and a stage holds one
    tile's enc and sh rows as the producer copies them."""
    plan = sc.smem_plan()
    assert plan["barriers"] >= (2 * plan["stages"] + 1) * 8
    assert (plan["barriers"] + plan["weights"]) % 128 == 0
    assert plan["stage"] % 128 == 0
    assert plan["stage"] == sc.TILE_ROWS * 64 + sc.TILE_ROWS * 32
    assert 4 <= plan["stages"] <= 6
    assert plan["total"] == plan["barriers"] + plan["weights"] \
        + plan["stages"] * plan["stage"] <= 232448


@pytest.mark.parametrize("n", [1, 127, 128, 129, 262149])
def test_tile_schedule_covers_every_row_once(n):
    """The kernel's schedule (persistent blocks over TILE_ROWS-row tiles,
    64 rows a consumer warpgroup) takes every row of n exactly once on the
    H100's 132 SMs, one or two blocks each, and each block's copies stay
    whole multiples of 16 bytes (64-byte enc and 32-byte sh rows)."""
    from nerfsafetyvalidation_tpu_torch.ops.hopper import _nvcc
    for per_sm in (1, 2):
        blocks = _nvcc.ring_grid(n, sc.TILE_ROWS, 132, per_sm)
        assert 1 <= blocks <= 132 * per_sm
        covered = np.zeros(n, np.int64)
        for _, _, start, stop in _nvcc.ring_rows(n, sc.TILE_ROWS, blocks):
            assert 0 < stop - start <= 64
            covered[start:stop] += 1
        assert (covered == 1).all()
        rows_last = n - (-(-n // sc.TILE_ROWS) - 1) * sc.TILE_ROWS
        assert rows_last * 32 % 16 == 0 and 0 < rows_last <= sc.TILE_ROWS


def test_cpu_wrapper_is_the_plain_version():
    enc, sh, sn, cn = _torch(*_chain(rows=40))
    before = sc.LAUNCHES
    got = sc.fused_sigma_color(enc, sh, sn, cn)
    want = sc.fused_sigma_color_plain(enc, sh, sn, cn)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert sc.LAUNCHES == before          # the plain path is never counted


def test_non_cpu_tensor_never_takes_the_plain_path():
    """The meta device has no kernel, so the wrapper must raise."""
    _, _, sn, cn = _chain(rows=8)
    with pytest.raises(ValueError):
        sc.fused_sigma_color(
            torch.empty((8, 32), dtype=torch.bfloat16, device="meta"),
            torch.empty((8, 16), dtype=torch.bfloat16, device="meta"),
            [torch.empty(w.shape, device="meta") for w in sn],
            [torch.empty(w.shape, device="meta") for w in cn])


def _teacher_params(net_j, seed=3):
    """The JAX pytree's shapes, filled by numpy; the sigma output's lane 0
    biased up so that the field has occupied space."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["sigma_net"][-1][:, 0] = np.abs(p["sigma_net"][-1][:, 0])
    return p


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def teacher(request):
    cfg_j = JConfig(**NET, compute_dtype=request.param)
    net_j = j_make(cfg_j)
    p = _teacher_params(net_j)
    p_j = jax.tree_util.tree_map(jnp.asarray, p)
    net_t = t_make(TConfig(**NET, compute_dtype=request.param),
                   params_from_jax(p, device="cpu"), device="cpu")
    net_t.to_folded()
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    d = rng.normal(size=(1000, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return request.param, cfg_j, net_j, net_j.to_folded(p_j), net_t, x, d


def _tol(dtype):
    # measured here: 4.0e-7 relative (f32) and 2.2e-7 (bf16) at most. f32:
    # the same operations in other sum orders. bf16: bounded at one bf16
    # step (2^-8), so that an encoding or activation that lands on the
    # neighbouring bf16 value under another sum order still passes
    return (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -8, 1e-5)


def test_teacher_density_matches_jax(teacher):
    dtype, _, net_j, fp_j, net_t, x, _ = teacher
    ref = net_j.density(fp_j, jnp.asarray(x))
    got = net_t.density(torch.from_numpy(x))
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(got["sigma"].numpy(),
                               np.asarray(ref["sigma"]), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(got["geo_feat"].numpy(),
                               np.asarray(ref["geo_feat"]).astype(np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("fused", [False, True])
def test_teacher_apply_matches_jax(teacher, fused):
    dtype, cfg_j, _, fp_j, net_t, x, d = teacher
    net_j = j_make(replace(cfg_j, fused=fused))
    s_j, c_j = net_j.apply(fp_j, jnp.asarray(x), jnp.asarray(d))
    s_t, c_t = net_t(torch.from_numpy(x), torch.from_numpy(d))
    assert float(np.asarray(s_j).max()) < np.exp(15.0)   # no clip at 15
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=rtol,
                               atol=atol)


def test_teacher_apply_routes_through_k3(teacher, monkeypatch):
    """With cfg.fused the forward runs K3 (the JAX `apply` with fused);
    without it, `density` then `color`, which never reach K3."""
    *_, net_unfused, x, d = teacher
    net_t = t_make(replace(net_unfused.cfg, fused=True),
                   net_unfused.params_tree(), device="cpu").to_folded()
    calls = []
    real = sc.fused_sigma_color

    def spy(enc, *a, **k):
        calls.append(tuple(enc.shape))
        return real(enc, *a, **k)

    import nerfsafetyvalidation_tpu_torch.models.network_mip as nm
    monkeypatch.setattr(nm, "fused_sigma_color", spy)
    net_t(torch.from_numpy(x[:64]), torch.from_numpy(d[:64]))
    assert calls == [(64, net_t.in_dim)]
    net_unfused(torch.from_numpy(x[:64]), torch.from_numpy(d[:64]))
    assert calls == [(64, net_t.in_dim)]
