"""K4's kernels timed on one CUDA card at chip_smoke.py's shapes, for the
port at a given root, so that two commits can be timed in one call.

    python3 nerfsafetyvalidation_tpu_torch/scripts/k4_time.py [--root DIR]

Through the wrappers a user calls, with chip_smoke.cuda_ms (device time,
the card kept busy while the calls are queued):
  * the bf16 pair and the f32 pair: the hash-grid sigma net [32, 64, 16]
    and color net [31, 64, 64, 3] at the smoke's tile of 2,097,152 rows
    (4,096 rays x 512 samples), as phases 10 and 10c time them;
  * the grouped mode at chip_smoke.K4G_SHAPES[0] (16 x 256 rows of the FF
    sigma net), its weights strided views of flat vectors, as phase 25.
Inputs and weights come from a seeded generator (the smoke's tile holds
a real frame's features), and each part is timed REPEATS times in turn.
Prints one JSON line with the card's name and power limit. It checks
nothing: chip_smoke.py holds each kernel against its plain version.

--root: import the port from DIR, a checkout of another commit (its
kernels built into DIR's own _build/); chip_smoke comes from this
script's checkout. Run it once a checkout, in separate processes (one
package name), e.g. parent, change, change, parent.
"""

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
SIGMA, COLOR = [32, 64, 16], [31, 64, 64, 3]
ROWS = 4096 * 512
REPEATS = 3


def chain(torch, widths, rows, gen, dev):
    x = torch.randn((rows, widths[0]), generator=gen, device=dev)
    ws = [torch.randn((a, b), generator=gen, device=dev) * (2.0 / a) ** 0.5
          for a, b in zip(widths, widths[1:])]
    return x, ws


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(CHECKOUT))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(Path(args.root).resolve()), str(CHECKOUT)]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k4_time: needs a CUDA device")
    import chip_smoke as S
    K = importlib.import_module(
        "nerfsafetyvalidation_tpu_torch.ops.hopper.fused_mlp")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(1)
    f32, bf = torch.float32, torch.bfloat16
    xs, wss = zip(*[chain(torch, w, ROWS, gen, dev) for w in (SIGMA, COLOR)])
    xb = [x.to(bf) for x in xs]

    def pair_bf16():
        return [K.fused_mlp(x, ws) for x, ws in zip(xb, wss)]

    def pair_f32():
        return [K.fused_mlp(x, ws, f32) for x, ws in zip(xs, wss)]

    G, N, widths = S.K4G_SHAPES[0][:3]
    xg = torch.randn((G, N, widths[0]), generator=gen, device=dev).to(bf)
    theta = torch.randn((G, sum(a * b for a, b in zip(widths, widths[1:]))),
                        generator=gen, device=dev) * 0.2
    wg, start = [], 0
    for a, b in zip(widths, widths[1:]):
        wg.append(theta[:, start:start + a * b].reshape(G, b, a)
                  .transpose(-1, -2))
        start += a * b

    def grouped():
        return K.fused_mlp_grouped(xg, wg)

    parts = (("bf16_pair_ms", pair_bf16, 20), ("f32_pair_ms", pair_f32, 10),
             ("grouped_ms", grouped, 50))
    out = {name: [] for name, _, _ in parts}
    for _ in range(REPEATS):
        for name, fn, reps in parts:
            out[name].append(S.cuda_ms(torch, fn, reps))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps(dict(root=args.root, module=K.__file__,
                          build_s=build_s, rows=ROWS, grouped=[G, N, widths],
                          card=smi, **out)), flush=True)


if __name__ == "__main__":
    main()
