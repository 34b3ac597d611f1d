"""Kernels K6 and K7: the row gather out = table[idx] of the gather probe.

`vmem_gather` and `dma_gather` are the counterparts of the JAX package's
Pallas kernels `pallas_vmem_gather` and `pallas_dma_gather`
(scripts/bench_gather.py): the first read rows from a table held in fast
memory, the second starts one asynchronous copy per row with `nslot` in
flight. On a CUDA tensor each launches its hand-written kernel in
`csrc/gather_rows.cu` or raises; on a CPU tensor each runs the plain
version `gather_plain`, which the tests compare with JAX.

The TPU kernels drop the last M % tile_m rows; these write every row.
K7 takes tile_m, the TPU grid step, and leaves it unused: its block size
is its own (`dma_geometry`).

The kernels are built at first use with `nvcc` into `_build/` beside the
package and bound with ctypes.
"""

import ctypes
from pathlib import Path

import torch

from ._nvcc import compile_source

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "gather_rows.cu"

# launches of each CUDA kernel since the last reset (never the plain path)
LAUNCHES_VMEM = 0
LAUNCHES_DMA = 0
# nvcc's report (registers, shared memory, spills) of the last build
BUILD_LOG = ""
# K7's launch: about this many one-warp blocks per SM, each taking a whole
# number of 32-row index loads, at most MAX_BLOCK_ROWS rows
BLOCKS_PER_SM = 8
MAX_BLOCK_ROWS = 4096
MAX_GROUP = 8            # rows of one slot group (csrc/gather_rows.cu)
H100_SMS = 132

_lib = None


def build() -> Path:
    """Compile the kernels if their library for this source is missing;
    returns the library's path."""
    global BUILD_LOG
    lib, log = compile_source(SOURCE)
    if log:
        BUILD_LOG = log
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        args = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
            + [ctypes.c_int] * 2
        lib.vmem_gather.argtypes = args + [ctypes.c_void_p]
        lib.dma_gather.argtypes = args + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        lib.vmem_gather.restype = lib.dma_gather.restype = ctypes.c_int
        _lib = lib
    return _lib


def gather_plain(table, idx):
    """The kernels' function in plain PyTorch: table [R, C], idx [M] ->
    [M, C]."""
    return table[idx.long()]


def _align128(v):
    return -(-v // 128) * 128


def dma_geometry(M, row_bytes, nslot, sms=H100_SMS):
    """K7's launch for M rows of row_bytes with nslot rows in flight per
    block: (blocks, rows a block, rows a slot group, shared-memory bytes).
    Block b takes rows [b * rows, (b + 1) * rows) of M; a slot group is the
    largest of 8, 4, 2, 1 rows that divides nslot into at least two groups
    (one group when nslot is 1); the shared memory holds the groups'
    barriers, the block's indices and the nslot slots."""
    group = next(g for g in (MAX_GROUP, 4, 2, 1)
                 if nslot % g == 0 and (g < nslot or nslot == 1))
    rows = -(-M // (sms * BLOCKS_PER_SM))
    rows = min(MAX_BLOCK_ROWS, max(32, -(-rows // 32) * 32))
    blocks = -(-M // rows)
    smem = _align128(nslot // group * 8) + _align128(rows * 4) \
        + nslot * row_bytes
    return blocks, rows, group, smem


def _launch(name, table, idx, tile_m, *extra):
    """Checks the operands, launches `name` and returns out [M, C]."""
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be float32 [R, C], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx must be int32 [M], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError("table and idx must be on one device")
    R, C = table.shape
    row_bytes = C * table.element_size()
    if row_bytes % 16:
        raise ValueError(f"a row of {row_bytes} bytes is not a whole number "
                         "of 16-byte chunks")
    if table.device.type != "cuda":
        raise ValueError(f"the row gathers run on CUDA or CPU tensors, not "
                         f"{table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must start on a 16-byte boundary")
    if tile_m <= 0:
        raise ValueError(f"tile_m must be positive, got {tile_m}")
    M = idx.shape[0]
    out = torch.empty((M, C), dtype=table.dtype, device=table.device)
    if M:
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream(table.device).cuda_stream
            err = getattr(_library(), name)(
                table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, M,
                row_bytes, tile_m, *extra, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def vmem_gather(table, idx, tile_m: int = 2048):
    """table [R, C] float32, idx [M] int32 -> table[idx] [M, C] (K6): a
    block per tile_m indices, staged in shared memory; rows copied in
    16-byte chunks, so C * 4 must be a multiple of 16. Indices must lie in
    [0, R); the kernel writes a zero row for one that does not."""
    global LAUNCHES_VMEM
    if table.device.type == "cpu":
        return gather_plain(table, idx)
    out = _launch("vmem_gather", table, idx, tile_m)
    if idx.shape[0]:
        LAUNCHES_VMEM += 1
    return out


def dma_gather(table, idx, tile_m: int = 2048, nslot: int = 16):
    """table[idx] as `vmem_gather` takes it (K7): one bulk copy per row into
    a ring of nslot shared-memory slots per one-warp block, each lane
    starting its own row's copy, and one bulk store per group of landed
    rows. tile_m is the TPU kernel's grid step, checked and not used: the
    blocks' rows are `dma_geometry`'s."""
    global LAUNCHES_DMA
    if table.device.type == "cpu":
        return gather_plain(table, idx)
    if nslot <= 0:
        raise ValueError(f"nslot must be positive, got {nslot}")
    if tile_m <= 0:
        raise ValueError(f"tile_m must be positive, got {tile_m}")
    sms = H100_SMS
    if table.device.type == "cuda":
        sms = torch.cuda.get_device_properties(
            table.device).multi_processor_count
    _, rows, group, _ = dma_geometry(idx.shape[0], table.shape[-1] * 4,
                                     nslot, sms)
    out = _launch("dma_gather", table, idx, rows, nslot, group)
    if idx.shape[0]:
        LAUNCHES_DMA += 1
    return out
