"""The K7 designs that PERF.md compares, timed on the card beside the
port's K7, K6 and `index_select` at the gather probe's K7 shapes.

    python3 -m nerfsafetyvalidation_tpu_torch.scripts.k7_variants

The variants (kernels in scripts/k7_variants.cu; no entry point of the
port launches them) take `table[idx]` through a ring of nslot row slots
per block, filled by one bulk copy per row and emptied by four consumer
warps through registers:

  (a) one issuing lane, one block per 2048 rows (the TPU's tile_m): the
      port's first K7;
  (b) every lane of the producer warp issues its own slots' rows, 2048
      rows a block;
  (c) one issuing lane at the port's K7 geometry (`gather.dma_geometry`:
      about 8 blocks per SM);
  (b+c) both;
  (d) the port's K7 (`gather.dma_gather`): (b) and (c), with the landed
      rows written back by bulk stores of whole runs of output rows.

K6 (`gather.vmem_gather`, 16-byte loads through L2) and `index_select`
are timed on the same table and indices. Every variant is checked
bit-exact against table[idx] before it is timed. One JSON line per shape:
the device milliseconds of each, the rows a block, and the card's name and
power limit from nvidia-smi. Tables and indices come from a seeded
torch.Generator on the card.
"""

import ctypes
import json
from pathlib import Path

import torch

from ..ops.hopper import gather
from ..ops.hopper._nvcc import compile_source
from .bench_gather import card, device_seconds

SOURCE = Path(__file__).resolve().with_name("k7_variants.cu")
# the probe's K7 shapes (section F): (R, C, M); every variant at nslot 16
SHAPES = [(2 ** 19, 64, 2 ** 18), (2 ** 15, 256, 2 ** 17),
          (2 ** 15, 512, 2 ** 17)]
NSLOT = 16
TPU_TILE_M = 2048
REPS = 20
# nvcc's report (registers, shared memory, spills) of the last build
BUILD_LOG = ""

_lib = None


def build() -> Path:
    """Compile the variants if their library for this source is missing;
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
        lib.k7_variant.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
            + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.k7_variant.restype = ctypes.c_int
        _lib = lib
    return _lib


def ring_gather(table, idx, tile_m, nslot, lanes):
    """table[idx] through variant `lanes` (False: one issuing lane; True:
    every lane issues) with tile_m rows a block. CUDA tensors only: table
    float32 [R, C] with C * 4 a multiple of 16, idx int32 [M]."""
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError("the K7 variants run on CUDA tensors only")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("table must be float32, idx int32")
    table, idx = table.contiguous(), idx.contiguous()
    R, C = table.shape
    M = idx.shape[0]
    out = torch.empty((M, C), dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _library().k7_variant(int(lanes), table.data_ptr(),
                                    idx.data_ptr(), out.data_ptr(), R, M,
                                    C * 4, tile_m, nslot, stream)
    if err != 0:
        raise RuntimeError(f"k7_variant launch failed: cudaError {err}")
    return out


def measure(table, idx, nslot=NSLOT, device_name=None, reps=REPS):
    """One record of every design on (table, idx): milliseconds by name,
    each checked bit-exact first (raises otherwise)."""
    M = idx.shape[0]
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    rows = gather.dma_geometry(M, table.shape[1] * 4, nslot, sms)[1]
    runs = {
        "a_single_issuer_tile2048":
            lambda: ring_gather(table, idx, TPU_TILE_M, nslot, False),
        "b_lane_issuers_tile2048":
            lambda: ring_gather(table, idx, TPU_TILE_M, nslot, True),
        "c_single_issuer_port_geometry":
            lambda: ring_gather(table, idx, rows, nslot, False),
        "bc_lane_issuers_port_geometry":
            lambda: ring_gather(table, idx, rows, nslot, True),
        "d_port_k7": lambda: gather.dma_gather(table, idx, nslot=nslot),
        "k6_vmem_gather": lambda: gather.vmem_gather(table, idx),
        "index_select": lambda: torch.index_select(table, 0, idx),
    }
    want = gather.gather_plain(table, idx)
    for name, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"K7 variant {name} is not bit-exact")
    ms = {name: device_seconds(fn, reps) * 1e3 for name, fn in runs.items()}
    R, C = table.shape
    return {"R": R, "C": C, "M": M, "nslot": nslot, "port_block_rows": rows,
            "ms": ms, "device": device_name}


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("k7_variants: no CUDA device; this runs on the "
                         "card only")
    dev = torch.device("cuda", 0)
    name = card()
    gen = torch.Generator(device=dev).manual_seed(7)
    records = []
    for R, C, M in SHAPES:
        table = torch.randn((R, C), generator=gen, device=dev)
        idx = torch.randint(0, R, (M,), generator=gen, device=dev,
                            dtype=torch.int32)
        rec = measure(table, idx, device_name=name)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
