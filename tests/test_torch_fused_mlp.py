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


def _b_address_tf32(k, n, cols):
    """Element offset of B[k, n] (k in A order) in one f32 image of `cols`
    columns, as the kernel's descriptor states the layout (csrc/sm90.cuh
    b_desc with 4-byte elements): 8-deep k-steps one after another,
    8-column groups 256 bytes apart, the two 4-deep halves of a k-step 128
    bytes apart, 8 x 4 core matrices of 16-byte rows (one column, 4
    depths)."""
    return ((k // 8) * 8 * cols + (n // 8) * 64 + ((k % 8) // 4) * 32
            + (n % 8) * 4 + k % 4)


def _read_back_f32(packed, widths):
    """Every tensor-core layer's (hi, lo) images read out of the f32 buffer
    through the descriptor's address function, each k-step's rows put back
    from K_ORDER into the weights' order: (hi [K_l, N_l], lo [K_l, N_l]);
    an FFMA layer's weights [K_l, FMA_OUT] as they lie."""
    order = torch.tensor(K.K_ORDER)
    layers, off = [], 0
    for kind, rows, cols in K._f32_layers(widths):
        if kind == "fma":
            layers.append(packed[off:off + rows * cols].reshape(rows, cols))
            off += rows * cols
            continue
        k, n = torch.meshgrid(torch.arange(rows), torch.arange(cols),
                              indexing="ij")
        pair = []
        for _ in range(2):
            img = packed[off + _b_address_tf32(k, n, cols)]
            back = torch.empty_like(img)
            # image row 8 s + i holds weight row 8 s + K_ORDER[i]
            back[(k // 8 * 8 + order[k % 8])[:, 0]] = img
            pair.append(back)
            off += rows * cols
        layers.append(tuple(pair))
    assert off == packed.numel()
    return layers


def test_f32_image_of_the_ref_nets():
    """Every tensor-core layer zero-padded to [K_l, N_l] (powers of two, 8
    at least), split into tf32 hi and lo images, hi then lo; a last layer
    at most FMA_OUT wide (the color net's 3) as its exact f32 weights
    [64, 4] for the FFMA route; one layer after the other: the sigma net
    [32, 64] x 2 + [64, 16] x 2 (24 KB), the color net [32, 64] x 2 +
    [64, 64] x 2 + [64, 4] (49 KB), both resident in a block beside a ring
    of four 192-row tiles of x. Read back through the descriptor's address
    function, hi + lo gives every weight within 2^-21 of it, and zero
    outside it."""
    for name, want in (("sigma", [("tf32", 32, 64), ("tf32", 64, 16)]),
                       ("color", [("tf32", 32, 64), ("tf32", 64, 64),
                                  ("fma", 64, 4)])):
        _, ws = _chain(NETS[name], seed=4)
        ws_t = [torch.from_numpy(w) for w in ws]
        widths, packed = K._prepare_f32(ws_t)
        assert widths == NETS[name] and K._fixed_net(widths)
        assert K._f32_layers(widths) == want
        assert packed.dtype == torch.float32 and packed.is_contiguous()
        for w, got in zip(ws_t, _read_back_f32(packed, widths)):
            a, b = w.shape
            if not isinstance(got, tuple):           # the FFMA layer
                assert torch.equal(got[:a, :b], w)
                assert not got[a:].any() and not got[:, b:].any()
                continue
            hi, lo = got
            assert torch.equal(hi, K.tf32_round(hi))
            assert torch.equal(lo, K.tf32_round(lo))
            rel = ((hi + lo)[:a, :b] - w).abs() / w.abs()
            assert float(rel.max()) <= 2.0 ** -21
            for img in (hi, lo):
                assert not img[a:].any() and not img[:, b:].any()
        plan = K._plan_f32(widths)
        assert plan["resident"] and plan["stages"] == K.MAX_STAGES_F32
        assert plan["stage"] == 64 * K.F32_CONSUMERS * widths[0] * 4
        assert plan["weights"] == 4 * packed.numel()
        assert plan["weights"] == {"sigma": 24576, "color": 50176}[name]
        assert K._prepare_f32(ws_t)[1] is packed       # built once
        assert K._prepare(ws_t)[1] is not packed       # the bf16 image apart


@pytest.mark.parametrize("layers", range(1, K.MAX_LAYERS + 1))
def test_f32_plan_takes_every_shape(layers):
    """The f32 kernel takes every chain the contract allows (1-8 layers,
    widths 1-128): its weight images stay in shared memory where they fit
    beside one stage, else one layer at a time; at least one stage of x
    fits, copies stay 16-byte aligned, and a block's shared memory fits
    232,448 bytes either way. A last layer at most FMA_OUT wide, and only
    that, takes the FFMA route; widths are padded to 64 or 128 but in the
    nets with builds of their own."""
    for d_in in (None, 1, 31, 128):
        for width in range(1, K.MAX_WIDTH + 1):
            widths = [d_in or width] + [width] * layers
            plan = K._plan_f32(widths)
            assert plan["stages"] in (1, 2, 4) and plan["stages"] <= \
                K.MAX_STAGES_F32
            assert 0 < plan["total"] <= K.MAX_SMEM
            rows = 64 * (K.F32_CONSUMERS if max(widths) <= 64 else 1)
            assert plan["stage"] == rows * widths[0] * 4
            assert (plan["barriers"] + plan["weights"]) % 16 == 0
            assert plan["stage"] % 16 == 0
            shapes = K._f32_layers(widths)
            kinds = [kind for kind, _, _ in shapes]
            assert kinds == ["tf32"] * (layers - 1) + [
                "fma" if width <= K.FMA_OUT else "tf32"]
            sizes_in = (8, 16, 32, 64, 128) if K._fixed_net(widths) \
                else (64, 128)
            for (kind, k, n), a, b in zip(shapes, widths, widths[1:]):
                assert k in sizes_in and k >= a
                assert (n in sizes_in and n >= b
                        if kind == "tf32" else n == K.FMA_OUT >= b)
            sizes = [K._layer_bytes(*layer) for layer in shapes]
            assert all(size % 16 == 0 for size in sizes)
            assert plan["weights"] == (sum(sizes) if plan["resident"]
                                       else max(sizes))
            assert plan["resident"] == (sum(sizes) + plan["stage"]
                                        <= K.MAX_SMEM - plan["barriers"])
            ws = [torch.zeros((a, b)) for a, b in zip(widths, widths[1:])]
            assert K._widths(ws, f32=True) == widths


@pytest.mark.parametrize("n_cols", [8, 16, 32, 64, 128])
def test_f32_layer_split_covers_every_output_once(n_cols):
    """The f32 kernel's register chain (csrc/fused_mlp.cu tf32_layer) for
    a layer of n_cols inputs and n_cols outputs, a warpgroup's 64 rows:
    thread (warp, g, t4)'s accumulator register 4 s + 2 h + c is row
    16 warp + g + 8 h, column 8 s + 2 t4 + c, and every output is held
    once; it becomes the next layer's A fragment (register q of k-step s:
    rows g, g + 8, g, g + 8, A columns t4, t4, t4 + 4, t4 + 4) through
    v[4 s + q] = acc[4 s + (0, 2, 1, 3)[q]], and A times the image's rows
    in K_ORDER, read through the descriptor's address function, is the
    product with the weights in their own order, exactly."""
    gen = torch.Generator().manual_seed(n_cols)
    h = torch.randn((64, n_cols), generator=gen, dtype=torch.float64)
    w = torch.randn((n_cols, n_cols), generator=gen, dtype=torch.float64)
    img = K.wgmma_b_tf32(w)
    warp, g, t4, s, q = torch.meshgrid(
        torch.arange(4), torch.arange(8), torch.arange(4),
        torch.arange(n_cols // 8), torch.arange(4), indexing="ij")
    # the accumulator: every output once
    acc_row = 16 * warp + g + 8 * ((q >> 1) & 1)
    acc_col = 8 * s + 2 * t4 + (q & 1)
    held = torch.zeros((64, n_cols), dtype=torch.int64)
    held.index_put_((acc_row.reshape(-1), acc_col.reshape(-1)),
                    torch.ones(acc_row.numel(), dtype=torch.int64),
                    accumulate=True)
    assert (held == 1).all()
    # v[4 s + q] = acc[4 s + (0, 2, 1, 3)[q]]: A register q's row and column
    src = torch.tensor([0, 2, 1, 3])[q]
    a_row = 16 * warp + g + 8 * (q & 1)
    a_col = 8 * s + t4 + 4 * (q >> 1)               # A order
    assert torch.equal(a_row, 16 * warp + g + 8 * ((src >> 1) & 1))
    logical = 8 * s + 2 * t4 + (src & 1)            # the accumulator's
    out = torch.zeros((64, n_cols), dtype=torch.float64)
    for n in range(n_cols):
        b = img[_b_address_tf32(a_col, torch.full_like(a_col, n), n_cols)]
        out[:, n].index_add_(0, a_row.reshape(-1),
                             (h[a_row, logical] * b).reshape(-1))
    torch.testing.assert_close(out, h @ w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kin", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("d_out", [1, 3, 4])
def test_f32_fma_layer_sums_every_input_once(d_out, kin):
    """The FFMA last layer's split (csrc/fused_mlp.cu fma_last) over kin
    inputs: thread t4 of a quad sums columns 8 s + 2 t4 (+ 1) of its rows
    (its v registers), the butterfly over the quad (lanes xor 1, then 2)
    adds the four partial sums, so every output is each input's term once
    (the product, exactly in float64), and thread 0 writes it. The quad's
    four 16-byte loads of a step (inputs 2 t4 apart in the [K, 4] weights)
    fall on distinct groups of 4 banks."""
    gen = torch.Generator().manual_seed(d_out * kin)
    h = torch.randn((2, kin), generator=gen, dtype=torch.float64)
    w = torch.zeros((kin, K.FMA_OUT), dtype=torch.float64)
    w[:, :d_out] = torch.randn((kin, d_out), generator=gen,
                               dtype=torch.float64)
    part = torch.zeros((4, 2, K.FMA_OUT), dtype=torch.float64)
    terms = torch.zeros((2, kin), dtype=torch.int64)
    for t4 in range(4):
        for s in range(kin // 8):
            for c in range(2):
                k = 8 * s + 2 * t4 + c
                part[t4] += h[:, k:k + 1] * w[k]
                terms[:, k] += 1
    assert (terms == 1).all()
    for lanes in (1, 2):                                 # the butterfly
        part = part + part[[t ^ lanes for t in range(4)]]
    assert all(torch.equal(part[t], part[0]) for t in range(4))
    torch.testing.assert_close(part[0][:, :d_out], h @ w[:, :d_out],
                               rtol=1e-12, atol=1e-12)
    groups = {(2 * t4 * K.FMA_OUT) % 32 // 4 for t4 in range(4)}
    assert len(groups) == 4


def test_tf32_round_is_cvt_rna():
    """tf32_round keeps 10 mantissa bits, rounding to nearest with ties
    away from zero (cvt.rna): on both sides of a tie, on a tie of either
    sign, and where rounding up carries into the exponent."""
    bits = torch.tensor([0x3F800FFF, 0x3F801000, 0x3F801001, 0xBF801000,
                         0x3FFFF000, 0x00000000, 0x80001000], dtype=torch.int64)
    want = torch.tensor([0x3F800000, 0x3F802000, 0x3F802000, 0xBF802000,
                         0x40000000, 0x00000000, 0x80002000], dtype=torch.int64)
    x = bits.to(torch.int32).view(torch.float32)
    got = K.tf32_round(x).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(got, want)


@pytest.mark.parametrize("net", sorted(NETS))
def test_tf32_split_gives_back_every_weight(net):
    """hi + lo gives back every weight of the net within 2^-21 of it,
    relative; both are tf32 values (13 low bits zero) and lo is at most
    half a tf32 step of hi."""
    _, ws = _chain(NETS[net], seed=7)
    for w in ws:
        w = torch.from_numpy(w) * 1e3 ** torch.randn(w.shape).clamp(-2, 2)
        hi, lo = K.tf32_split(w)
        for part in (hi, lo):
            assert not (part.view(torch.int32) & 0x1FFF).any()
        assert float(((hi + lo - w).abs() / w.abs()).max()) <= 2.0 ** -21
        assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("net", sorted(NETS))
def test_tf32_emulation_matches_xla_chain(net):
    """The f32 kernel's arithmetic (three tf32 products a term, f32 sums)
    against the JAX package's f32 chain `_xla_mlp(..., float32)` at the
    tolerance the JAX package holds its f32 kernel to (tests/
    test_fused_mlp.py: rtol 5e-4, atol 1e-5)."""
    x, ws = _chain(NETS[net], rows=300, seed=11)
    want = np.asarray(J._xla_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                 jnp.float32))
    got = K.fused_mlp_tf32_emulated(torch.from_numpy(x),
                                    [torch.from_numpy(w) for w in ws])
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("net", sorted(NETS))
def test_three_tf32_products_beat_one_by_100x(net):
    """Why the kernel takes three tf32 products a term: against the chain
    in float64, their largest error on these rows is at least 100x smaller
    than a single tf32 product's (10 mantissa bits an operand)."""
    x, ws = _chain(NETS[net], rows=300, seed=12)
    h = x.astype(np.float64)
    for i, w in enumerate(ws):
        h = h @ w.astype(np.float64)
        if i != len(ws) - 1:
            h = np.maximum(h, 0.0)
    xt, wt = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    err3 = np.abs(K.fused_mlp_tf32_emulated(xt, wt).numpy() - h).max()
    err1 = np.abs(K.fused_mlp_tf32_emulated(xt, wt, products=1).numpy()
                  - h).max()
    assert err3 * 100 <= err1, (err3, err1)


# ------------------------------------------------------- K4 grouped's images
GROUPED_NETS = {"ff_sigma": [32, 64, 64, 16], "ragged": [24, 48, 8],
                "color": [31, 64, 64, 3]}


@pytest.mark.parametrize("G", [1, 3, 16])
@pytest.mark.parametrize("net", sorted(GROUPED_NETS))
def test_grouped_index_map_gives_each_groups_image(net, G):
    """The grouped kernel's in-block index map (csrc/fused_mlp.cu
    pack_group, mirrored by `grouped_image_mirror`) over the strided views
    that `set_sigma_net_flat` makes of G sims' flat vectors: each group's
    image equals `wgmma_b` of that group's contiguous bf16 weights, bit for
    bit, zero padding included."""
    from nerfsafetyvalidation_tpu_torch.models.network import NeRFNetwork
    widths = GROUPED_NETS[net]
    layers = [torch.empty((a, b)) for a, b in zip(widths, widths[1:])]
    n = sum(a * b for a, b in zip(widths, widths[1:]))
    theta = torch.from_numpy(np.random.default_rng(G).normal(
        0, 1, (G, n)).astype(np.float32))
    views = NeRFNetwork.set_sigma_net_flat(
        type("Net", (), {"sigma_net": layers})(), theta)
    assert [tuple(v.shape) for v in views] == [(G, a, b) for a, b in
                                               zip(widths, widths[1:])]
    assert not any(v.is_contiguous() for v in views)
    assert K._grouped_widths(views) == widths
    for g in range(G):
        want = torch.cat([
            wgmma_b(torch.nn.functional.pad(
                v[g].to(torch.bfloat16),
                (0, K._pad16(v.shape[2]) - v.shape[2],
                 0, K._pad16(v.shape[1]) - v.shape[1])))
            for v in views])
        got = K.grouped_image_mirror(views, g)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert torch.equal(got, K._pack([v[g].contiguous()
                                         for v in views])[1])
