"""Kernel K4 of the port (ops/hopper/fused_mlp.py) against the JAX package
on the CPU: its plain version `fused_mlp_plain` against the JAX Pallas
kernel `fused_mlp`, run in interpret mode as tests/test_fused_mlp.py runs
it, and against the XLA chain `_xla_mlp`, which keeps the last layer in
f32; the wrapper's dispatch (a CPU tensor takes the plain version, any
other tensor never does) and its packing of the weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops.pallas import fused_mlp as J
from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as K
from nerfsafetyvalidation_tpu_torch.ops.hopper.points_mlp import wgmma_b

torch.set_num_threads(1)

# the hash-grid field's sigma and color nets, and the FFMLP topology's
NETS = {"sigma": [32, 64, 16], "color": [31, 64, 64, 3],
        "ff_sigma": [32, 64, 64, 16]}


def _chain(dims, rows=300, seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 1.5 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    x = rng.normal(0, 1.0, (rows, dims[0])).astype(np.float32)
    return x, ws


def _tol(dtype):
    # f32: JAX's own kernel-vs-XLA tolerance (tests/test_fused_mlp.py).
    # bf16: every layer rounds to bf16; where the sum order lands an output
    # on the neighbouring bf16 value (relative step 2^-8), later layers move
    # by a fraction of that step; bounded at the step itself
    return (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -8, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_plain_matches_jax_kernel(net, dtype):
    x, ws = _chain(NETS[net], rows=257)
    want = np.asarray(J.fused_mlp(jnp.asarray(x),
                                  [jnp.asarray(w) for w in ws],
                                  compute_dtype=getattr(jnp, dtype),
                                  interpret=True))
    got = K.fused_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                      getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    if dtype == "bfloat16":      # every output is a bf16 value
        g = got.numpy()
        np.testing.assert_array_equal(
            torch.from_numpy(g).to(torch.bfloat16).float().numpy(), g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_plain_vs_xla_chain(net, dtype):
    """`_xla_mlp` is the same chain with the last layer kept in f32: the
    plain version equals it rounded to the compute dtype there."""
    x, ws = _chain(NETS[net], rows=211, seed=1)
    want = np.array(J._xla_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                 getattr(jnp, dtype)))
    got = K.fused_mlp_plain(torch.from_numpy(x),
                            [torch.from_numpy(w) for w in ws],
                            getattr(torch, dtype))
    rtol, atol = _tol(dtype)
    want_rounded = torch.from_numpy(want).to(getattr(torch, dtype)).float()
    np.testing.assert_allclose(got.numpy(), want_rounded.numpy(), rtol=rtol,
                               atol=atol)
    if dtype == "bfloat16":      # the one stated difference shows
        assert np.abs(got.numpy() - want).max() > 0


def test_cpu_wrapper_is_the_plain_version():
    x, ws = _chain(NETS["color"], rows=40)
    x_t, ws_t = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    before = K.LAUNCHES
    torch.testing.assert_close(K.fused_mlp(x_t, ws_t),
                               K.fused_mlp_plain(x_t, ws_t), rtol=0, atol=0)
    assert K.LAUNCHES == before          # the plain path is never counted


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_non_cpu_tensor_never_takes_the_plain_path(dtype):
    """The meta device has no kernel, so the wrapper must raise, whatever
    the compute dtype."""
    ws = [torch.empty((32, 64), device="meta"),
          torch.empty((64, 16), device="meta")]
    with pytest.raises(ValueError):
        K.fused_mlp(torch.empty((8, 32), dtype=torch.bfloat16,
                                device="meta"), ws, dtype)


def _b_address(k, n, cols):
    """Element offset of B[k, n] in one layer's wgmma image of `cols`
    columns, as the kernel's descriptor states the layout (csrc/sm90.cuh
    b_desc: K-major, no swizzle): 16-deep k-steps one after another,
    8-column groups 256 bytes apart, the two 8-deep halves of a k-step 128
    bytes apart, 8 x 8 core matrices of 16-byte rows (one column, 8
    depths)."""
    return ((k // 16) * 16 * cols + (n // 8) * 128 + ((k % 16) // 8) * 64
            + (n % 8) * 8 + k % 8)


def _read_back(packed, widths):
    """The padded layers [pad16(in), pad16(out)] read out of the image
    through the descriptor's address function, in order."""
    bits = packed.view(torch.int16)
    layers, off = [], 0
    for a, b in zip(widths, widths[1:]):
        rows, cols = K._pad16(a), K._pad16(b)
        k, n = torch.meshgrid(torch.arange(rows), torch.arange(cols),
                              indexing="ij")
        layers.append(bits[off + _b_address(k, n, cols)]
                      .view(torch.bfloat16))
        off += rows * cols
    assert off == packed.numel()
    return layers


def test_prepared_weights_are_packed_and_padded():
    _, ws = _chain(NETS["color"])
    ws_t = [torch.from_numpy(w) for w in ws]
    widths, packed = K._prepare(ws_t)
    assert widths == [31, 64, 64, 3]
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() == 32 * 64 + 64 * 64 + 64 * 16
    c1, _, c3 = _read_back(packed, widths)
    torch.testing.assert_close(c1[:31], ws_t[0].to(torch.bfloat16),
                               rtol=0, atol=0)
    assert not c1[31].any() and not c3[:, 3:].any()
    assert K._prepare(ws_t)[1] is packed          # built once per weights
    with torch.inference_mode():                  # inference-mode weights
        assert K._prepare([torch.from_numpy(w) for w in ws])[0] == widths


# the ref nets, the FFMLP topology, and chains through widths 1, 3, 16, 31,
# 33, 64 and 128 (each as the input, the hidden and the output width)
IMAGE_CHAINS = [NETS[k] for k in sorted(NETS)] + [
    [w, 64, w] for w in (1, 3, 16, 31, 33, 64, 128)] + [
    [33, w, 3] for w in (1, 3, 16, 31, 33, 64, 128)]


@pytest.mark.parametrize("dims", IMAGE_CHAINS,
                         ids=["-".join(map(str, d)) for d in IMAGE_CHAINS])
def test_wgmma_image_gives_back_every_padded_weight(dims):
    """The packed image read back through the descriptor's address
    function gives every layer, bit for bit, zero-padded to [16k, 16m], in
    the kernel's layer order; nothing else."""
    _, ws = _chain(dims, rows=1, seed=sum(dims))
    ws_t = [torch.from_numpy(w) for w in ws]
    widths, packed = K._prepare(ws_t)
    assert widths == dims
    for got, w in zip(_read_back(packed, widths), ws_t):
        a, b = w.shape
        assert tuple(got.shape) == (K._pad16(a), K._pad16(b))
        assert torch.equal(got[:a, :b].view(torch.int16),
                           w.to(torch.bfloat16).view(torch.int16))
        assert not got[a:].any() and not got[:, b:].any()


@pytest.mark.parametrize("shapes", [[(32, 64), (16, 15)],
                                    [(32, 129), (129, 3)],
                                    [(8, 8)] * 9])
def test_shapes_beyond_the_kernel_raise(shapes):
    """Weights that do not chain, a width past 128, or more than 8
    layers."""
    with pytest.raises(ValueError):
        K._prepare([torch.zeros(s) for s in shapes])


def test_shared_memory_of_the_ref_nets():
    """The block's shared memory (the kernel's plan): barriers, the weight
    image (6 KB for the sigma net, 14 KB for the color net) and the full
    ring of 128-row tiles of x (64-byte rows for the sigma net, 62-byte
    rows for the color net)."""
    sigma, color = K._plan(NETS["sigma"]), K._plan(NETS["color"])
    assert sigma["weights"] == 2 * 3072 and color["weights"] == 2 * 7168
    assert sigma["stage"] == 128 * 64 and color["stage"] == 128 * 62
    assert sigma["stages"] == color["stages"] == K.MAX_STAGES
    assert sigma["total"] == 128 + 2 * 3072 + 6 * 128 * 64
    assert color["total"] == 128 + 2 * 7168 + 6 * 128 * 62


def _smem_before(widths):
    """The shared memory of the kernel this one replaced (four warps, two
    16-row activation tiles and an f32 16 x 16 stage each, the row-major
    weights): the shapes that fitted it are the shapes the wrapper took."""
    w_elems = sum(K._pad16(a) * K._pad16(b) for a, b in zip(widths,
                                                            widths[1:]))
    pitch = max(16, *(K._pad16(v) for v in widths)) + 8
    return 2 * w_elems + 4 * 2 * 16 * pitch * 2 + 4 * 256 * 4


@pytest.mark.parametrize("layers", range(1, K.MAX_LAYERS + 1))
def test_shared_memory_plan_fits_every_shape(layers):
    """For every depth and every width 1..128 (the same width throughout,
    and each of 1, 31, 128 as the input with that width inside): where the
    plan has a stage it fits 232,448 bytes, keeps 16-byte copies aligned
    and the wrapper takes the shape; where it has none the wrapper raises;
    and every shape the replaced kernel took still fits."""
    for d_in in (None, 1, 31, 128):
        for width in range(1, K.MAX_WIDTH + 1):
            widths = [d_in or width] + [width] * layers
            plan = K._plan(widths)
            ws = [torch.zeros((a, b)) for a, b in zip(widths, widths[1:])]
            if plan["stages"]:
                assert plan["total"] <= K.MAX_SMEM
                assert plan["stages"] <= K.MAX_STAGES
                assert (plan["barriers"] + plan["weights"]) % 16 == 0
                assert plan["stage"] % 16 == 0
                assert plan["barriers"] >= (2 * K.MAX_STAGES + 1) * 8
                assert K._widths(ws) == widths
            else:
                with pytest.raises(ValueError):
                    K._widths(ws)
            if _smem_before(widths) <= K.MAX_SMEM:
                assert plan["stages"] >= 1, widths


@pytest.mark.parametrize("n", [1, 127, 128, 129, 262149])
def test_tile_schedule_covers_every_row_once(n):
    """The kernel's schedule (persistent blocks over TILE_ROWS-row tiles,
    64 rows a consumer warpgroup) takes every row of n exactly once on the
    H100's 132 SMs; a ragged last tile is bulk-copied up to its last
    16-byte boundary and the rest (under 16 bytes) by hand, for the ref
    nets' 32- and 31-wide inputs."""
    from nerfsafetyvalidation_tpu_torch.ops.hopper import _nvcc
    blocks = _nvcc.ring_grid(n, K.TILE_ROWS, 132)
    assert 1 <= blocks <= 132
    covered = np.zeros(n, np.int64)
    for _, _, start, stop in _nvcc.ring_rows(n, K.TILE_ROWS, blocks):
        assert 0 < stop - start <= 64
        covered[start:stop] += 1
    assert (covered == 1).all()
    rows_last = n - (-(-n // K.TILE_ROWS) - 1) * K.TILE_ROWS
    for d0 in (32, 31):
        nbytes = rows_last * d0 * 2
        assert nbytes - (nbytes & ~15) < 16
        assert (n - rows_last) * d0 * 2 % 16 == 0   # the tile starts aligned


def test_cache_keeps_its_weights_alive():
    """A cached entry holds its weights, so freed weights cannot hand their
    storage (and with it the cache key) to new weights of the same shape:
    new weights always get their own packed buffer."""
    packed = []
    for seed in range(4):
        _, ws = _chain(NETS["sigma"], seed=seed)
        ws_t = [torch.from_numpy(w) for w in ws]
        packed.append(K._prepare(ws_t)[1])
        want = torch.cat([wgmma_b(ws_t[0].to(torch.bfloat16)),
                          wgmma_b(ws_t[1].to(torch.bfloat16))])
        torch.testing.assert_close(packed[-1], want, rtol=0, atol=0)
        del ws, ws_t


# ------------------------------------------------------------ K4 in f32


def test_cpu_wrapper_f32_is_the_plain_version():
    x, ws = _chain(NETS["sigma"], rows=40)
    x_t, ws_t = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    before = (K.LAUNCHES, K.LAUNCHES_F32)
    torch.testing.assert_close(K.fused_mlp(x_t, ws_t, torch.float32),
                               K.fused_mlp_plain(x_t, ws_t, torch.float32),
                               rtol=0, atol=0)
    assert (K.LAUNCHES, K.LAUNCHES_F32) == before


def test_f32_non_cpu_tensor_never_takes_the_plain_path():
    """An f32 call on a tensor off the CPU goes to the f32 kernel or
    raises (the meta device has no kernel): it never runs the plain
    version, and counts no launch."""
    ws = [torch.empty((31, 64), device="meta"),
          torch.empty((64, 64), device="meta"),
          torch.empty((64, 3), device="meta")]
    before = (K.LAUNCHES, K.LAUNCHES_F32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.fused_mlp(torch.empty((8, 31), device="meta"), ws, torch.float32)
    assert (K.LAUNCHES, K.LAUNCHES_F32) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_requiring_input_raises(dtype):
    """Checks that an input or weight that requires grad is ACCEPTED, in
    either compute dtype: on the CPU the output carries K4's backward (the
    VJP of `fused_mlp_reference`), and the only error left is the device
    check's ValueError off the CPU and the card (the meta device), which
    any meta call raises. The name is kept from when K4 had no backward
    and refused such an input."""
    ws = [torch.empty((32, 64), device="meta"),
          torch.empty((64, 16), device="meta", requires_grad=True)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.fused_mlp(torch.empty((8, 32), device="meta"), ws, dtype)
    x = torch.empty((8, 32), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.fused_mlp(x, [w.detach() for w in ws], dtype)
    out = K.fused_mlp(torch.ones((8, 32), requires_grad=True),
                      [torch.ones((32, 64)), torch.ones((64, 16))], dtype)
    assert type(out.grad_fn).__name__ == "_K4Backward"


def test_f32_other_compute_dtypes_raise():
    ws = [torch.empty((32, 16), device="meta")]
    with pytest.raises(ValueError):
        K.fused_mlp(torch.empty((8, 32), device="meta"), ws, torch.float16)


@pytest.mark.parametrize("shapes", [[(32, 64), (16, 15)],
                                    [(32, 129), (129, 3)],
                                    [(8, 8)] * 9])
def test_f32_shapes_beyond_the_kernel_raise(shapes):
    with pytest.raises(ValueError):
        K._prepare_f32([torch.zeros(s) for s in shapes])


def test_f32_image_of_the_ref_nets():
    """Every layer zero-padded to [K_l, N_l] f32 row-major, one after the
    other: the sigma net [32, 64] + [64, 16] (12 KB), the color net
    [32, 64] + [64, 64] + [64, 16] (28 KB), both resident in a block
    beside the 128 x 68-float activation tile."""
    for name, want_shapes in (("sigma", [(32, 64), (64, 16)]),
                              ("color", [(32, 64), (64, 64), (64, 16)])):
        _, ws = _chain(NETS[name], seed=4)
        ws_t = [torch.from_numpy(w) for w in ws]
        widths, packed = K._prepare_f32(ws_t)
        assert widths == NETS[name]
        assert K._f32_shapes(widths) == want_shapes
        assert packed.dtype == torch.float32 and packed.is_contiguous()
        off = 0
        for w, (k, n) in zip(ws_t, want_shapes):
            layer = packed[off:off + k * n].reshape(k, n)
            assert torch.equal(layer[:w.shape[0], :w.shape[1]], w)
            assert not layer[w.shape[0]:].any()
            assert not layer[:, w.shape[1]:].any()
            off += k * n
        assert off == packed.numel()
        plan = K._plan_f32(widths)
        assert plan["resident"] and plan["pitch"] == 68
        assert plan["weights"] == 4 * off
        assert K._prepare_f32(ws_t)[1] is packed       # built once
        assert K._prepare(ws_t)[1] is not packed       # the bf16 image apart


@pytest.mark.parametrize("layers", range(1, K.MAX_LAYERS + 1))
def test_f32_plan_takes_every_shape(layers):
    """The f32 kernel takes every chain the contract allows (1-8 layers,
    widths 1-128): its weights stay in shared memory where they fit beside
    the activation tile, else one layer at a time, and a block's shared
    memory fits 232,448 bytes either way."""
    for d_in in (None, 1, 31, 128):
        for width in range(1, K.MAX_WIDTH + 1):
            widths = [d_in or width] + [width] * layers
            plan = K._plan_f32(widths)
            assert plan["total"] <= K.MAX_SMEM
            assert plan["pitch"] % 4 == 0 and plan["pitch"] % 32 in (4, 20)
            shapes = K._f32_shapes(widths)
            assert all(n in (16, 32, 64, 128) and k % 16 == 0
                       for k, n in shapes)
            sizes = [4 * k * n for k, n in shapes]
            assert plan["weights"] == (sum(sizes) if plan["resident"]
                                       else max(sizes))
            ws = [torch.zeros((a, b)) for a, b in zip(widths, widths[1:])]
            assert K._widths(ws, f32=True) == widths


@pytest.mark.parametrize("n_cols", [16, 32, 64, 128])
def test_f32_layer_split_covers_every_output_once(n_cols):
    """The f32 kernel's split of a layer (csrc/fused_mlp.cu f32_layer):
    256 threads, N / 4 column groups of 4 adjacent columns, 1024 / N row
    groups, thread (rg, cg) holding rows rg + (1024 / N) i: every output
    of the 128-row tile once; the rows one warp reads start on distinct
    banks or are the same row (pitch 68 or 132 floats: 4 banks apart)."""
    cg_n = n_cols // 4
    rg_n = 256 // cg_n
    tm = 128 // rg_n
    covered = np.zeros((128, n_cols), np.int64)
    for t in range(256):
        rg, cg = divmod(t, cg_n)
        for i in range(tm):
            covered[rg + rg_n * i, 4 * cg:4 * cg + 4] += 1
    assert (covered == 1).all()
    for pitch in (68, 132):
        for warp in range(8):
            rows = {t // cg_n for t in range(32 * warp, 32 * warp + 32)}
            banks = [(r * pitch) % 32 for r in rows]
            # each row's float4 covers 4 banks: no two rows overlap
            spans = {b + j for b in banks for j in range(4)}
            assert len(spans) == 4 * len(rows)
