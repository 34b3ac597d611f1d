"""Microbenchmark of the random-row gather on the card: the port of the JAX
package's probe scripts/bench_gather.py, at its sizes.

    python3 -m nerfsafetyvalidation_tpu_torch.scripts.bench_gather [--quick]
        [--only SECTIONS]

The JAX package's design rests on that probe's TPU numbers (every
random-row gather there floors at ~15-25 ns/row); this measures the same
things on a CUDA card:

  A. `index_select` rate vs row WIDTH, 1 B to 4 KB (R = 2^19; 2^17 above
     512 B);
  B. vs index PATTERN (random / sorted / runs of 2 and 4 / all the same),
     256 B rows;
  C. vs table SIZE, 2^13 to 2^21 rows of 256 B;
  D. scatter: `index_copy_` for the probe's `.at[].set`, `index_add_` for
     `.add`, into 2^19 rows;
  E. kernel K6 (`ops.hopper.gather.vmem_gather`) on tables of 1-4 MiB;
  F. kernel K7 (`ops.hopper.gather.dma_gather`) with nslot 4 / 16 / 32
     copies in flight, and with 1 and 2 KB rows;
  G. sequential rows (iota indices), the bandwidth bound;
  H. the trilinear corner fetch of the mip-fold training encode: 8 single
     rows ("take8"), 4 / 2 / 1 windows per sample ("pairs", "quads",
     "cube"; `ops.mip_encoding.corner_windows`) and one fold row
     ("fold-row"), forward and forward + VJP, at F = 128, C = 16.

`--quick` halves M (2^20) and runs section H at one M. `--only` keeps the
probe's meaning exactly: `--only H` runs section H alone; any other list
runs sections A-G, and H first if the list names it.

One JSON line per measurement (rows/s, ns/row, GB/s, the row's bytes, a
note, and the card's name and power limit from nvidia-smi), then a summary
table. Times are device times from CUDA events around `REPS` calls after
one warm-up call: in sections A-G of the gather (or scatter) call alone
(the TPU probe timed a sum of its result with it, to fetch one number); in
H of the probe's loss sum(fetch * w), and of its gradient. Tables and
indices come from a seeded torch.Generator on the card. Nothing is caught:
a failing section fails the run.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops.hopper import gather
from ..ops.mip_encoding import corner_windows

REPS = 10
RESULTS = []


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_seconds(fn, reps=REPS):
    """Mean device seconds of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / 1e3


def make_idx(gen, pattern, M, R):
    """M int32 indices into R rows, on the generator's device."""
    dev = gen.device
    if pattern in ("random", "sorted"):
        i = torch.randint(0, R, (M,), generator=gen, device=dev,
                          dtype=torch.int32)
        return torch.sort(i).values if pattern == "sorted" else i
    if pattern.startswith("runs"):
        k = int(pattern[4:])
        base = torch.randint(0, R, (M // k,), generator=gen, device=dev,
                             dtype=torch.int32)
        return base.repeat_interleave(k)
    if pattern == "same":
        return torch.zeros((M,), dtype=torch.int32, device=dev)
    if pattern == "iota":
        return (torch.arange(M, device=dev) % R).to(torch.int32)
    raise ValueError(pattern)


def record(name, rows, dt, bytes_per_row, note="", device=""):
    rate = rows / dt
    rec = {"name": name, "rows_per_s": round(rate),
           "ns_per_row": round(1e9 * dt / rows, 2),
           "GB_per_s": round(rate * bytes_per_row / 1e9, 2),
           "row_bytes": bytes_per_row, "note": note, "device": device}
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def sections(only):
    """The sections to run, in order, for --only (None: all): H alone for
    exactly {H}; else H first if named, then A-G as the probe orders them
    (G, A, B, C, D, E, F)."""
    if only is not None and set(only) == {"H"}:
        return ["H"]
    return (["H"] if only is None or "H" in only else []) \
        + ["G", "A", "B", "C", "D", "E", "F"]


# A/B/C/G: index_select

def bench_take(gen, R, width_bytes, pattern, M, dev_name, sorted_flag=False):
    """Rows of uint8 for a 1-byte width (a 1-D table, as the probe's), of
    float32 otherwise."""
    if width_bytes == 1:
        table = torch.randint(0, 255, (R,), generator=gen, device=gen.device,
                              dtype=torch.uint8)
    else:
        table = torch.randn((R, max(1, width_bytes // 4)), generator=gen,
                            device=gen.device)
    idx = make_idx(gen, pattern, M, R)
    dt = device_seconds(lambda: torch.index_select(table, 0, idx))
    note = ("the probe's indices_are_sorted=True: torch has no such flag, "
            "so this is the unflagged call again") if sorted_flag else ""
    record(f"take R=2^{int(np.log2(R))} w={width_bytes}B {pattern}"
           + (" sortedflag" if sorted_flag else ""), M, dt, width_bytes,
           note, dev_name)


# D: scatter

def bench_scatter(gen, B, width_bytes, M, dev_name, mode="set"):
    C = max(1, width_bytes // 4)
    vals = torch.randn((M, C), generator=gen, device=gen.device)
    idx = torch.randint(0, B, (M,), generator=gen, device=gen.device)

    def f():
        out = torch.zeros((B, C), device=gen.device)
        if mode == "set":
            return out.index_copy_(0, idx, vals)
        return out.index_add_(0, idx, vals)

    dt = device_seconds(f)
    record(f"scatter-{mode} B=2^{int(np.log2(B))} w={width_bytes}B", M, dt,
           width_bytes, "index_copy_" if mode == "set" else "index_add_",
           dev_name)


# E / F: kernels K6 and K7

def bench_vmem(gen, R, C, M, dev_name):
    table = torch.randn((R, C), generator=gen, device=gen.device)
    idx = make_idx(gen, "random", M, R)
    dt = device_seconds(lambda: gather.vmem_gather(table, idx))
    record(f"pallas-vmem-gather R=2^{int(np.log2(R))} w={C * 4}B", M, dt,
           C * 4, "K6 (csrc/gather_rows.cu vmem_gather)", dev_name)


def bench_dma(gen, R, C, M, nslot, dev_name):
    table = torch.randn((R, C), generator=gen, device=gen.device)
    idx = make_idx(gen, "random", M, R)
    dt = device_seconds(lambda: gather.dma_gather(table, idx, nslot=nslot))
    record(f"pallas-dma-gather R=2^{int(np.log2(R))} w={C * 4}B "
           f"nslot={nslot}", M, dt, C * 4,
           "K7 (csrc/gather_rows.cu dma_gather)", dev_name)


# H: trilinear corner-fetch strategies (the mip-fold training encode)

def corner_strategies(F, C, device="cpu"):
    """{name: fn(table [(F+1)^3, C], ci [M, 3] int64) -> [M, 8, C]}, the
    corners in the probe's order (z fastest: corner 4x + 2y + z)."""
    bits = torch.as_tensor(np.stack(np.meshgrid(
        [0, 1], [0, 1], [0, 1], indexing="ij"), -1).reshape(8, 3),
        device=device)

    def take8(t, ci):
        corner = ci[:, None, :] + bits[None]
        rows = (corner[..., 0] * (F + 1) + corner[..., 1]) * (F + 1) \
            + corner[..., 2]
        return t[rows.reshape(-1)].reshape(ci.shape[0], 8, C)

    def windows(mode):
        def fn(t, ci):
            return corner_windows(t, ci, F, C, mode).reshape(
                ci.shape[0], 8, C)
        return fn

    return {"take8": take8, "pairs": windows("pair"),
            "quads": windows("quad"), "cube": windows("cube")}


def bench_corner_strategies(gen, F, C, M, dev_name):
    dev = gen.device
    table = torch.randn(((F + 1) ** 3, C), generator=gen, device=dev)
    ci = torch.randint(0, F, (M, 3), generator=gen, device=dev)
    # the fold baseline: one [F^3, 8C] row per sample (the render layout)
    fold = torch.randn((F ** 3, 8 * C), generator=gen, device=dev)
    cif = torch.randint(0, F ** 3, (M,), generator=gen, device=dev)
    w = torch.randn((M, 8, C), generator=gen, device=dev)

    def fold_fetch(t, i):
        return t[i].reshape(M, 8, C)

    for name, fn in list(corner_strategies(F, C, dev).items()) \
            + [("fold-row", fold_fetch)]:
        t_in, i_in = (fold, cif) if name == "fold-row" else (table, ci)
        t_req = t_in.clone().requires_grad_()

        def fwd():
            with torch.no_grad():
                return (fn(t_in, i_in) * w).sum()

        def vjp():
            return torch.autograd.grad((fn(t_req, i_in) * w).sum(), t_req)

        record(f"corners8-{name} F={F} C={C} fwd", M, device_seconds(fwd),
               8 * C * 4, "per 8-corner sample", dev_name)
        record(f"corners8-{name} F={F} C={C} fwd+vjp", M,
               device_seconds(vjp), 8 * C * 4,
               "includes the scatter-add backward", dev_name)


def summary():
    print("\n# ---- summary (rows/s) ----")
    for r in RESULTS:
        print(f"{r['name']:55s} {r['rows_per_s'] / 1e6:9.1f} M rows/s  "
              f"{r['ns_per_row']:8.1f} ns/row  {r['GB_per_s']:8.2f} GB/s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma list of sections to run, e.g. H")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gather: no CUDA device; the probe measures "
                         "the card only")
    only = args.only.split(",") if args.only else None
    dev_name = card()
    print(f"# card: {dev_name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    M = 2 ** 20 if args.quick else 2 ** 21
    del RESULTS[:]

    for sec in sections(only):
        if sec == "H":
            print("# H. trilinear corner-fetch strategies (train path)",
                  flush=True)
            for m in [2 ** 16] + ([] if args.quick else [2 ** 18]):
                bench_corner_strategies(gen, 128, 16, m, dev_name)
        elif sec == "G":
            print("# G. bandwidth sanity: sequential rows (iota idx)",
                  flush=True)
            bench_take(gen, 2 ** 19, 256, "iota", M, dev_name)
            bench_take(gen, 2 ** 19, 1024, "iota", M // 4, dev_name)
        elif sec == "A":
            print("# A. width sweep (random idx, R=2^19)", flush=True)
            for w, m_scale in [(1, 1), (4, 1), (32, 1), (128, 1), (256, 1),
                               (512, 2), (1024, 4), (2048, 8), (4096, 16)]:
                R = 2 ** 19 if w <= 512 else 2 ** 17  # tables <= ~512 MB
                bench_take(gen, R, w, "random", M // m_scale, dev_name)
        elif sec == "B":
            print("# B. pattern sweep (w=256B, R=2^19)", flush=True)
            for pat in ["random", "sorted", "runs2", "runs4", "same"]:
                bench_take(gen, 2 ** 19, 256, pat, M, dev_name)
            bench_take(gen, 2 ** 19, 256, "sorted", M, dev_name,
                       sorted_flag=True)
        elif sec == "C":
            print("# C. table-size sweep (w=256B, random)", flush=True)
            for lr in [13, 15, 17, 21]:
                bench_take(gen, 2 ** lr, 256, "random", M, dev_name)
        elif sec == "D":
            print("# D. scatter", flush=True)
            for w in [4, 64, 256]:
                bench_scatter(gen, 2 ** 19, w, M, dev_name)
            bench_scatter(gen, 2 ** 19, 256, M, dev_name, mode="add")
        elif sec == "E":
            print("# E. K6: VMEM-table gather, on the card through L2",
                  flush=True)
            for R, C in [(2 ** 13, 64), (2 ** 14, 64), (2 ** 13, 32)]:
                bench_vmem(gen, R, C, 2 ** 19, dev_name)
        elif sec == "F":
            print("# F. K7: per-row DMA gather (TMA bulk copies)",
                  flush=True)
            for nslot in [4, 16, 32]:
                bench_dma(gen, 2 ** 19, 64, 2 ** 18, nslot, dev_name)
            for C in [256, 512]:             # brick-sized rows
                bench_dma(gen, 2 ** 15, C, 2 ** 17, 16, dev_name)
    summary()
    return RESULTS


if __name__ == "__main__":
    main()
