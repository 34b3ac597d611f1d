"""Kernels K6 and K7 of the port (ops/hopper/gather.py) and the port of the
gather probe (nerfsafetyvalidation_tpu_torch/scripts/bench_gather.py), on
the CPU: the plain row gather against the JAX probe's Pallas kernels
`pallas_vmem_gather` and `pallas_dma_gather` run in interpret mode, the
wrappers' refusal to take the plain path for a tensor that is not on the
CPU, and the probe's section-H corner strategies against the JAX probe's
`_corner_strategies`. The JAX probe is loaded by path: scripts/ is not a
package."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerfsafetyvalidation_tpu_torch.ops.hopper import gather as G
from nerfsafetyvalidation_tpu_torch.scripts import bench_gather as B

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
R, C, M = 64, 16, 4096          # M: two tiles of 2048


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_gather", ROOT / "scripts" / "bench_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """The probe's pallas_call in interpret mode, for this test only."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _case(rows=R, cols=C, m=M, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, cols)).astype(np.float32)
    idx = rng.integers(0, rows, m).astype(np.int32)
    return table, idx


def test_vmem_plain_matches_jax_kernel(probe, interpret):
    table, idx = _case()
    want = np.asarray(probe.pallas_vmem_gather(jnp.asarray(table),
                                               jnp.asarray(idx)))
    got = G.gather_plain(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nslot", [4, 16, 32])
def test_dma_plain_matches_jax_kernel(probe, interpret, nslot):
    table, idx = _case(seed=nslot)
    want = np.asarray(probe.pallas_dma_gather(
        jnp.asarray(table), jnp.asarray(idx), nslot=nslot))
    got = G.gather_plain(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [1, 2047, 2049, 5000])
def test_cpu_wrappers_write_every_row_uncounted(m):
    """The TPU kernels drop the last M % tile_m rows; the port's wrappers
    write every row, and a CPU tensor takes the plain version, which no
    launch count sees."""
    table, idx = (torch.from_numpy(a) for a in _case(m=m, seed=m))
    before = (G.LAUNCHES_VMEM, G.LAUNCHES_DMA)
    for got in (G.vmem_gather(table, idx),
                G.dma_gather(table, idx, nslot=4)):
        assert got.shape == (m, C)
        assert torch.equal(got, table[idx.long()])
    assert (G.LAUNCHES_VMEM, G.LAUNCHES_DMA) == before


@pytest.mark.parametrize("fn", [G.vmem_gather, G.dma_gather])
def test_non_cpu_tensor_never_takes_the_plain_path(fn):
    """The meta device has no kernel, so the wrappers must raise."""
    table = torch.empty((R, C), device="meta")
    idx = torch.empty((M,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fn(table, idx)


@pytest.mark.parametrize("table_shape,idx_dtype,why", [
    ((R, C), torch.int64, "int32"),     # the kernels read int32 indices
    ((R, 3), torch.int32, "16-byte"),   # a 12-byte row
])
def test_operands_the_kernels_do_not_take_raise(table_shape, idx_dtype,
                                                why):
    table = torch.empty(table_shape, device="meta")
    idx = torch.empty((M,), dtype=idx_dtype, device="meta")
    for fn in (G.vmem_gather, G.dma_gather):
        with pytest.raises(ValueError, match=why):
            fn(table, idx)


def test_build_without_nvcc_raises():
    import shutil
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    with pytest.raises(RuntimeError):
        G.build()


# the probe's section H

F_H, C_H, M_H = 8, 4, 512


@pytest.fixture(scope="module")
def corner_case():
    rng = np.random.default_rng(3)
    table = rng.normal(size=((F_H + 1) ** 3, C_H)).astype(np.float32)
    ci = rng.integers(0, F_H, (M_H, 3)).astype(np.int32)
    w = rng.normal(size=(M_H, 8, C_H)).astype(np.float32)
    return table, ci, w


@pytest.mark.parametrize("name", ["take8", "pairs", "quads", "cube"])
def test_section_h_strategies_match_jax(probe, corner_case, name):
    """Values bit-exact (the same corners, in the probe's order); the
    gradient of sum(fetch * w) sums the same f32 terms in another order:
    measured 1.4e-6 apart at gradients up to 11 (1.3e-7 of the largest),
    bounded at 1e-6 of the largest."""
    table, ci, w = corner_case
    _, _, strats = probe._corner_strategies(F_H, C_H, M_H,
                                            jax.random.PRNGKey(0))
    fj = strats[name]
    want = np.asarray(fj(jnp.asarray(table), jnp.asarray(ci)))
    g_want = np.asarray(jax.grad(lambda t: jnp.sum(
        fj(t, jnp.asarray(ci)) * w))(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    got = B.corner_strategies(F_H, C_H)[name](t, torch.from_numpy(ci).long())
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(t.grad.numpy(), g_want, rtol=0,
                               atol=1e-6 * np.abs(g_want).max())


def test_probe_sections_follow_only():
    """--only keeps the JAX probe's meaning: H alone for exactly H; any
    other list runs A-G (in the probe's order), with H first if named."""
    rest = ["G", "A", "B", "C", "D", "E", "F"]
    assert B.sections(None) == ["H"] + rest
    assert B.sections(["H"]) == ["H"]
    assert B.sections(["A"]) == rest
    assert B.sections(["E", "H"]) == ["H"] + rest


def test_probe_index_patterns():
    gen = torch.Generator().manual_seed(0)
    for pattern in ["random", "sorted", "runs2", "runs4", "same", "iota"]:
        i = B.make_idx(gen, pattern, 64, 16)
        assert i.dtype == torch.int32 and i.shape == (64,)
        assert 0 <= int(i.min()) and int(i.max()) < 16
    assert torch.equal(B.make_idx(gen, "iota", 64, 16),
                       (torch.arange(64) % 16).int())
    s = B.make_idx(gen, "sorted", 64, 16)
    assert torch.equal(s, torch.sort(s).values)
    r = B.make_idx(gen, "runs4", 64, 16).reshape(16, 4)
    assert bool((r == r[:, :1]).all())
    assert not B.make_idx(gen, "same", 64, 16).any()


def test_probe_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit):
        B.main(["--quick"])


@pytest.mark.parametrize("m", [1, 2047, 2 ** 18 - 1000, 2 ** 18])
@pytest.mark.parametrize("nslot", [1, 4, 16, 32])
def test_dma_geometry_covers_every_row_once(m, nslot):
    """K7's blocks take consecutive runs of rows: together every row of M
    once; its slot groups split nslot into groups of at most 8 rows."""
    blocks, rows, group, _ = G.dma_geometry(m, 256, nslot)
    covered = np.zeros(m, np.int64)
    for b in range(blocks):
        covered[b * rows:min((b + 1) * rows, m)] += 1
    assert (covered == 1).all()
    assert rows % 32 == 0 and (blocks - 1) * rows < m <= blocks * rows
    assert nslot % group == 0 and group <= G.MAX_GROUP
    assert nslot // group >= 2 or nslot == 1


@pytest.mark.parametrize("shape", [(2 ** 19, 64, 2 ** 18),
                                   (2 ** 15, 256, 2 ** 17),
                                   (2 ** 15, 512, 2 ** 17),
                                   (2 ** 19, 64, 2 ** 18 - 1000)])
@pytest.mark.parametrize("nslot", [4, 16, 32])
def test_dma_geometry_fits_shared_memory(shape, nslot):
    """At every probe shape and nslot, K7's shared memory (barriers, index
    tile, slots) stays within a block's 232,448 bytes, with about 8 blocks
    per SM of the H100's 132."""
    _, cols, m = shape
    blocks, rows, _, smem = G.dma_geometry(m, cols * 4, nslot)
    assert smem <= 232448
    assert G.H100_SMS * G.BLOCKS_PER_SM * 0.9 <= blocks <= G.H100_SMS * \
        G.BLOCKS_PER_SM


def test_k7_variants_run_on_the_card_only():
    """The K7 designs kept as the probe's yardsticks take no CPU tensor
    (they have no plain version of their own: each is table[idx]), and
    their probe fails without a card instead of timing the CPU."""
    from nerfsafetyvalidation_tpu_torch.scripts import k7_variants
    table, idx = (torch.from_numpy(a) for a in _case())
    for lanes in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            k7_variants.ring_gather(table, idx, 2048, 16, lanes)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            k7_variants.main()
