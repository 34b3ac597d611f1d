"""Kernel K1 of the port (ops/hopper/points_mlp.py): its plain version
against the JAX package's Pallas kernel `fused_points_sigma_color`, run in
interpret mode on the CPU as tests/test_fused_mlp.py runs it; the operand
layout prepared for the CUDA kernel; and the wrapper's refusal to run a
non-CPU tensor anywhere but on the kernel."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops.pallas import render_mlp as j_mlp
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig
from nerfsafetyvalidation_tpu_torch.models.network import NeRFNetwork
from nerfsafetyvalidation_tpu_torch.ops.hopper import points_mlp as pm

# one torch thread: MKL's threaded sin/cos is not exact under load
# (see test_torch_ops.py)
torch.set_num_threads(1)


def _nets(hidden=32, n_sig=3, seed=9, rows=300):
    """A narrow student: sigma 75 -> hidden x (n_sig - 1) -> 16, color
    31 -> 64 -> 64 -> 3, numpy float32 [in, out]."""
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return rng.normal(0, 0.15, (i, o)).astype(np.float32)

    sn = [mat(75, hidden)] + [mat(hidden, hidden)
                              for _ in range(n_sig - 2)] + [mat(hidden, 16)]
    cn = [mat(31, 64), mat(64, 64), mat(64, 3)]
    x = rng.uniform(-1, 1, (rows, 3)).astype(np.float32)
    sh = rng.normal(0, 0.5, (rows, 16)).astype(np.float32)
    return x, sh, sn, cn


def _both(x, sh, sn, cn, j_dtype, t_dtype):
    s_j, c_j = j_mlp.fused_points_sigma_color(
        jnp.asarray(x), jnp.asarray(sh), [jnp.asarray(w) for w in sn],
        [jnp.asarray(w) for w in cn], 12, compute_dtype=j_dtype)
    s_t, c_t = pm.fused_points_sigma_color(
        torch.from_numpy(x), torch.from_numpy(sh),
        [torch.from_numpy(w) for w in sn], [torch.from_numpy(w) for w in cn],
        12, compute_dtype=t_dtype)
    return (s_t.numpy(), c_t.numpy()), (np.asarray(s_j), np.asarray(c_j))


def test_plain_matches_jax_kernel_f32():
    (s_t, c_t), (s_j, c_j) = _both(*_nets(), jnp.float32, torch.float32)
    # JAX's own kernel-vs-XLA tolerance (test_fused_mlp.py): the kernel's
    # cos is sin(t + pi/2) with t up to 2^11 rad, the plain chain's cos(t)
    np.testing.assert_allclose(s_t, s_j, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(c_t, c_j, rtol=5e-4, atol=1e-5)


def test_plain_matches_jax_kernel_bf16():
    (s_t, c_t), (s_j, c_j) = _both(*_nets(), jnp.bfloat16, torch.bfloat16)
    # bf16 operands: where the shifted-sine cos or the sum order lands an
    # activation on the neighbouring bf16 value (relative step 2^-8), the
    # outputs move; measured 6e-4 relative on sigma and 3.4e-4 on rgb for
    # these inputs, bounded here with a margin of about 8x
    np.testing.assert_allclose(s_t, s_j, rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=3e-3)


def test_cpu_wrapper_is_the_plain_version():
    x, sh, sn, cn = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                     else [torch.from_numpy(w) for w in a]
                     for a in _nets(rows=64))
    before = dict(pm.LAUNCHES_BY_WIDTH), pm.PLAIN_CALLS
    got = pm.fused_points_sigma_color(x, sh, sn, cn, 12)
    want = pm.fused_points_sigma_color_plain(x, sh, sn, cn, 12)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # the plain path is never counted as a launch, and counts as two plain
    # calls (the wrapper's and this test's)
    assert pm.LAUNCHES_BY_WIDTH == before[0]
    assert pm.PLAIN_CALLS == before[1] + 2


@pytest.mark.parametrize("hidden,n_sig", [(160, 6), (192, 3)])
def test_prepared_operands_match_tpu_padding(hidden, n_sig):
    """The bf16 operands handed to the CUDA kernel, laid out as the TPU
    kernel pads them (render_mlp.py _fused_points)."""
    _, _, sn, cn = _nets(hidden=hidden, n_sig=n_sig, rows=1)
    sn_t = [torch.from_numpy(w) for w in sn]
    cn_t = [torch.from_numpy(w) for w in cn]
    m = pm._prepare(sn_t, cn_t)
    bf = torch.bfloat16
    assert (m["hidden"], m["n_hidden"], m["n_color_mid"]) == \
        (hidden, n_sig - 2, 1)
    assert m["w1"].shape == (pm.ENC_COLS, hidden) and m["w1"].dtype == bf
    torch.testing.assert_close(m["w1"][:75], sn_t[0].to(bf))
    assert not m["w1"][75:].any()
    torch.testing.assert_close(m["wh"], torch.stack(sn_t[1:-1]).to(bf))
    torch.testing.assert_close(m["wlast"], sn_t[-1].to(bf))
    torch.testing.assert_close(m["c1s"], cn_t[0][:16].to(bf))
    assert not m["c1g"][0].any()          # the sigma lane feeds no color
    torch.testing.assert_close(m["c1g"][1:], cn_t[0][16:].to(bf))
    torch.testing.assert_close(m["cmid"][0], cn_t[1].to(bf))
    assert m["clast"].shape == (64, pm.LAST_COLS)
    torch.testing.assert_close(m["clast"][:, :3], cn_t[2].to(bf))
    assert not m["clast"][:, 3:].any()
    for k in ("w1", "wh", "wlast", "c1s", "c1g", "cmid", "clast"):
        assert m[k].is_contiguous()
    assert pm._prepare(sn_t, cn_t) is m   # built once per set of weights


def test_prepare_refuses_unsupported_widths():
    _, _, sn, cn = _nets(hidden=96, n_sig=3, rows=1)
    with pytest.raises(ValueError):
        pm._prepare([torch.from_numpy(w) for w in sn],
                    [torch.from_numpy(w) for w in cn])


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU launches the kernel or raises; the
    meta device has no kernel, so the wrapper must raise."""
    x, sh, sn, cn = _nets(rows=8)
    meta = [torch.empty(w.shape, device="meta") for w in sn]
    with pytest.raises(ValueError):
        pm.fused_points_sigma_color(
            torch.empty((8, 3), device="meta"),
            torch.empty((8, 16), dtype=torch.bfloat16, device="meta"),
            meta, [torch.empty(w.shape, device="meta") for w in cn], 12)


def test_cuda_request_without_a_card_raises():
    """Entry points default to device="cuda"; without a card they raise
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, _, sn, cn = _nets(hidden=160, n_sig=6, rows=1)
    cfg = NetworkConfig(encoding="frequency", multires=12, num_layers=6,
                        hidden_dim=160, compute_dtype="bfloat16", fused=True)
    with pytest.raises((RuntimeError, AssertionError)):
        NeRFNetwork(cfg, {"sigma_net": sn, "color_net": cn})


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or pm.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    with pytest.raises(RuntimeError):
        pm.build()


def test_build_key_covers_the_shared_header(tmp_path):
    """The three wgmma sources include csrc/sm90.cuh, and a library's key
    in the build directory hashes it: an edit to the header gives each of
    them a new key (so a stale library is never loaded), and leaves the
    sources that do not include it alone."""
    from nerfsafetyvalidation_tpu_torch.ops.hopper import _nvcc
    src = pm.SOURCE.parent
    names = ("points_mlp.cu", "sigma_color.cu", "fused_mlp.cu",
             "fold_build.cu", "sm90.cuh")
    for name in names:
        shutil.copy(src / name, tmp_path / name)
    users = [tmp_path / n for n in names[:3]]
    for path in users:
        assert [p.name for p in _nvcc.local_sources(path)] == [
            path.name, "sm90.cuh"]
    before = {n: _nvcc.source_digest(tmp_path / n) for n in names[:4]}
    assert before["points_mlp.cu"] == _nvcc.source_digest(pm.SOURCE)
    header = tmp_path / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _nvcc.source_digest(tmp_path / n) for n in names[:4]}
    assert all(after[p.name] != before[p.name] for p in users)
    assert after["fold_build.cu"] == before["fold_build.cu"]
    assert _nvcc.source_digest(users[0], ["-O2"]) != after["points_mlp.cu"]


def _b_address(k, n, cols):
    """Element offset of B[k, n] in one layer's wgmma image of `cols`
    columns, as the kernel's descriptor states the layout (K-major, no
    swizzle): 16-deep k-steps one after another, 8-column groups pm.B_SBO
    bytes apart, the two 8-deep halves of a k-step pm.B_LBO bytes apart,
    8 x 8 core matrices of 16-byte rows (one column, 8 depths)."""
    return ((k // 16) * 16 * cols + (n // 8) * (pm.B_SBO // 2)
            + ((k % 16) // 8) * (pm.B_LBO // 2) + (n % 8) * 8 + k % 8)


@pytest.mark.parametrize("hidden", pm.HIDDEN_WIDTHS)
def test_wgmma_image_gives_back_every_padded_weight(hidden):
    """The bf16 image read back through the descriptor's address function
    gives every padded weight of every layer, bit for bit, in the kernel's
    layer order, with zeros where the TPU kernel pads; nothing else."""
    _, _, sn, cn = _nets(hidden=hidden, n_sig=5, rows=1)
    sn_t = [torch.from_numpy(w) for w in sn]
    cn_t = [torch.from_numpy(w) for w in cn]
    m = pm._prepare(sn_t, cn_t)
    image = m["image"]
    assert image.dtype == torch.bfloat16 and image.dim() == 1
    bits = image.view(torch.int16)
    c1 = torch.cat([m["c1s"], m["c1g"]])
    layers = [m["w1"], *m["wh"], m["wlast"], c1, *m["cmid"], m["clast"]]
    shapes = [(80, hidden)] + [(hidden, hidden)] * 3 + [
        (hidden, 16), (32, 64), (64, 64), (64, 16)]
    assert [tuple(w.shape) for w in layers] == shapes
    off = 0
    for w in layers:
        k_in, cols = w.shape
        k, n = torch.meshgrid(torch.arange(k_in), torch.arange(cols),
                              indexing="ij")
        got = bits[off + _b_address(k, n, cols)]
        assert torch.equal(got, w.contiguous().view(torch.int16))
        off += k_in * cols
    assert off == image.numel()
    # the padding: W1's rows past the encoding, C1g's sigma row, C_last's
    # columns past rgb
    assert not m["w1"][75:].any() and not c1[16].any()
    assert not m["clast"][:, 3:].any()


@pytest.mark.parametrize("hidden", pm.HIDDEN_WIDTHS)
def test_weight_ring_fits_a_block(hidden):
    """Every chunk the bf16 kernel streams fits a stage (W1's 5 k-steps, a
    run of kSpc k-steps of a hidden layer, the tail with one middle color
    layer), the ring and the two encoding tiles fit the 232,448 bytes of
    shared memory a block may use, and a tail that outgrows its stage is
    refused."""
    spc, stage, stages = pm.RING[hidden]
    slab = 32 * hidden
    assert (hidden // 16) % spc == 0
    assert 5 * slab <= stage and spc * slab <= stage
    assert pm.tail_bytes(hidden, 1) <= stage
    assert pm.RING_BARRIER_BYTES >= 2 * stages * 8
    assert pm.RING_OFFSET % 128 == 0
    assert pm.RING_OFFSET + stages * stage <= 232448
    too_many = (stage - pm.tail_bytes(hidden, 0)) // 8192 + 1
    _, _, sn, _ = _nets(hidden=hidden, n_sig=3, rows=1)
    rng = np.random.default_rng(0)
    cn = [rng.normal(size=(31, 64)).astype(np.float32)] + [
        rng.normal(size=(64, 64)).astype(np.float32)
        for _ in range(too_many)] + [rng.normal(size=(64, 3))
                                     .astype(np.float32)]
    with pytest.raises(ValueError, match="stage"):
        pm._prepare([torch.from_numpy(w) for w in sn],
                    [torch.from_numpy(w) for w in cn])
    # the f32 kernel streams its chunks through shared memory of its own
    m32 = pm._prepare([torch.from_numpy(w) for w in sn],
                      [torch.from_numpy(w) for w in cn], torch.float32)
    assert m32["image"].dtype == torch.float32
