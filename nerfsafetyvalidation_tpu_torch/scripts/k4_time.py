"""K4's kernels, and K1's and K3's float32 kernels, timed on one CUDA card
at chip_smoke.py's shapes, for the port at a given root, so that two
commits can be timed in one call.

    python3 nerfsafetyvalidation_tpu_torch/scripts/k4_time.py [--root DIR]

Through the wrappers a user calls, with chip_smoke.cuda_ms (device time,
the card kept busy while the calls are queued):
  * the bf16 pair and the f32 pair: the hash-grid sigma net [32, 64, 16]
    and color net [31, 64, 64, 3] at the smoke's tile of 2,097,152 rows
    (4,096 rays x 512 samples), as phases 10 and 10c time them;
  * the grouped mode at chip_smoke.K4G_SHAPES[0] (16 x 256 rows of the FF
    sigma net), its weights strided views of flat vectors, as phase 25;
  * K1 in float32 at 131,072 rows (chip_smoke.K1_ROWS) for the
    students' widths H = 160, 192 and 256, 6 sigma layers and 3 color
    layers as the committed students have, and K3 in float32 at the guided
    and fast tiles' 262,144 and 2,097,152 rows, as phase 34 times them.
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
K1_WIDTHS = (160, 192, 256)
K3_ROWS = (262144, 2097152)


def chain(torch, widths, rows, gen, dev):
    x = torch.randn((rows, widths[0]), generator=gen, device=dev)
    ws = [torch.randn((a, b), generator=gen, device=dev) * (2.0 / a) ** 0.5
          for a, b in zip(widths, widths[1:])]
    return x, ws


def f32_parts(torch, S, gen, dev):
    """(name, call, reps) for K1 f32 at each width and K3 f32 at each tile,
    seeded inputs and weights (N(0, 1 / fan_in))."""
    pm = importlib.import_module(
        "nerfsafetyvalidation_tpu_torch.ops.hopper.points_mlp")
    sc = importlib.import_module(
        "nerfsafetyvalidation_tpu_torch.ops.hopper.sigma_color")
    pm.build()
    sc.build()
    f32 = torch.float32

    def mat(a, b):
        return torch.randn((a, b), generator=gen, device=dev) / a ** 0.5

    rows = S.K1_ROWS
    x = torch.rand((rows, 3), generator=gen, device=dev) * 2 - 1
    d = torch.randn((rows, 16), generator=gen, device=dev)
    sh = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    parts = []
    for hid in K1_WIDTHS:
        sn = [mat(75, hid)] + [mat(hid, hid) for _ in range(4)] + [
            mat(hid, 16)]
        cn = [mat(31, 64), mat(64, 64), mat(64, 3)]
        parts.append((f"k1_f32_h{hid}_ms",
                      lambda sn=sn, cn=cn: pm.fused_points_sigma_color(
                          x, sh, sn, cn, 12, f32), 10))
    w3 = [mat(a, b) for a, b in ((32, 64), (64, 16), (31, 64), (64, 64),
                                 (64, 3))]
    for n in K3_ROWS:
        enc = torch.randn((n, 32), generator=gen, device=dev) * 0.5
        sh3 = torch.randn((n, 16), generator=gen, device=dev) * 0.5
        parts.append((f"k3_f32_{n}_ms",
                      lambda enc=enc, sh3=sh3: sc.fused_sigma_color(
                          enc, sh3, w3[:2], w3[2:], f32), 20))
    return parts


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

    parts = [("bf16_pair_ms", pair_bf16, 20), ("f32_pair_ms", pair_f32, 10),
             ("grouped_ms", grouped, 50)] + f32_parts(torch, S, gen, dev)
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
