#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nerfsafetyvalidation_tpu_torch) on one
CUDA card.

    python3 chip_smoke.py

(`--closed-loop-intrinsics` runs only the probe of that name, below;
`--sequential` phases 22-24 alone, `--laplace` phases 25-28 alone,
`--fast-render` phases 29-32 alone, each on freshly trained nets;
`--distill` phase 33 alone; `--cli-options` phase 11d alone; `--f32`
phase 34 alone, after the bf16 frames it compares with.)
Phases, each printing its elapsed seconds:
  1. device: the card's name, and its power limit from nvidia-smi;
  2. build: kernels K1 and K2 (csrc/points_mlp.cu), K3
     (csrc/sigma_color.cu), K4 in bf16 and f32 (csrc/fused_mlp.cu), K5
     (csrc/fold_build.cu),
     K6 and K7 (csrc/gather_rows.cu) and the K7 variants that PERF.md
     compares (scripts/k7_variants.cu), one nvcc each, started together;
     each kernel's registers, stack and spills as ptxas reports them;
  3. teacher: the mip-fold teacher of bench_assets/flagship.ckpt loaded,
     folded, and its occupancy refreshed 4x with a seeded generator, as
     bench.py refreshes it before every mode;
  3b. kernel K5: the fold build of the teacher's own pyramid (F = 128,
     Cd = 16) forward, and backward on a seeded cotangent, in bf16 and in
     f32, each bit-exact against its plain version, with kernel, plain,
     library (forward: the plain version, one torch.stack call; backward:
     one index_add_, held to the kernel within rounding) and bound times;
  4. kernel K1: against its plain PyTorch version on 131,072 rows of points
     on real camera rays with the committed 160x6 student, with kernel,
     plain, library (bf16 torch.matmul chain) and bound times; the same
     rows through the committed 192- and 256-wide students (the
     baked_h192 and baked modes' nets), with the same four times each;
     then at the kernel's other widths, H = 192 and 256 (seeded weights,
     8,192 rows each), against its plain version;
  4b. kernel K2: the same rows' frequency encoding through K2 against its
     plain version in bf16 and in f32, and beside K1; K2's path, one
     forward and backward of a loss through K2 with the counts at 0 before
     and read after, its gradients equal to the plain chain's under
     autograd; the same four times, in f32 too (the library call there:
     the f32 torch.matmul chain with TF32 off);
  5. kernel K3: against its plain version on 262,144 rows (one guided fine
     tile: 16,384 rays x 16 samples in windows around the surface) of the
     teacher's own encoding, with the same four times; then on 2,097,152
     rows (one fast tile of pose 0: 131,072 rays x 16 slots, captured from
     the frame), the same, and 20 reruns bit-identical to the first; at
     both shapes the kernel timed again with cold inputs (copies rotated
     past the 50 MB L2);
  6. fast, guided: the teacher's marched frame and its depth-guided frame
     with the march prepass (bench.py's `fast` and `guided` settings) at
     800x800 on the "spheres" scene at the four held-out poses, through
     K3; mean PSNR against the analytic ground truth and its gap to the
     JAX package's BENCH_r05 numbers, tile buckets, rays/s, and pose 0
     rendered again through the plain version and compared;
  7. baked_h160_ak8: the baked-student guided frame on the same poses
     through K1, from the refreshed occupancy;
  8. ref net: the hash-grid reference backbone of bench_assets/refbb.ckpt
     (16 levels x 2 channels, corner layout, both MLPs through K4) loaded
     and its own occupancy refreshed 4x through it;
  9. kernel K4: against its plain version on one shaded fast tile of pose 0
     (131,072 rays x 16 slots) of that net, the sigma net on the net's own
     encoding and the color net on [SH | geo], with the same four times,
     20 reruns bit-identical to the first, and the kernel again with cold
     inputs;
 10. ref_backbone, ref_backbone_ml8: pose 0 (the pose bench.py scores) in
     bench.py's marched frame through K4, with all 16 levels and with the
     levels below 8; PSNR and its gap to BENCH_r05, pose 0 again through
     the plain version, and once more through the unfused plain matmul
     chain (the route BENCH_r05 ran), as a check;
 10c. kernel K4 f32: the same shaded tile through the float32 net (a
     fused float32 NeRFNetwork built directly; the CLI's --ff builds
     NeRFNetworkFF, bf16): the f32 kernel (3xTF32 wgmma) against its
     plain version at rtol 5e-4 / atol 1e-5, with kernel, plain, library
     (the f32 torch.matmul chain, TF32 off) and bound times (the f32
     CUDA cores' and the 3xTF32 route's), warm and cold, and 20 reruns
     bit-identical to the first; then at K4_F32_ODD's chains (widths to
     128, the weights resident and a layer at a time);
 10d. staged, staged_bf16: pose 0 at 800x800 through the staged render at
     the CLI's defaults (157 chunks of 4,096 rays x 512 samples), through
     K4's f32 kernel and its bf16 one: s/frame, rays/s, PSNR beside
     ref_backbone's, K4 launched twice a chunk, and a central chunk and
     the padded last one (its rgbs and sigmas too) again through the plain
     field, compared;
 10b. gradients: K1 on a CUDA tensor returns the plain chain's gradients
     (K3's are phase 34's); K4 in bf16 and in f32, on both nets of the
     ref backbone at 98,304 and 2,097,152 rows (a marched training step's
     rows and a uniform one's), launches its kernel once and returns the
     gradients of its recompute (the VJP of the JAX package's _xla_mlp)
     bit for bit;
 11. train: the teacher trained from a seeded init at full width
     (flagship.TRAIN_CFG, train_gather="foldrow_pallas") on the in-memory
     48-view 200x200 spheres set, 144 steps with the schedule cut (see
     TRAIN_STEPS): K5 launched once forward and once backward per step,
     the loss and the parameters finite, the loss falling by LOSS_FALL, the
     trainer's `evaluate` PSNR on the 2 validation views (the staged
     render); then one step through "foldrow_pallas" against one through
     "foldrow" from the trained parameters with the same draws, the updates
     compared;
 11b. dataset directory: the same 48-view set (and its 2 validation and 4
     test views) written as a blender directory through data/png.py, and
     decoded back equal, both timed;
 11c. main_nerf -O --ff, main_nerf --ff: the port's training CLI, as a
     user runs it, on that directory at the CLI's defaults (but --bound 1
     --scale 1): -O --ff 192 iters (4 epochs; the march) and --ff 8 iters
     (one epoch of 48 steps; 512 uniform samples a ray); both build
     NeRFNetworkFF (bf16, the FFMLP widths 32-64-64-16 and 32-64-64-64-3)
     and train it through K4's bf16 kernel forward and backward; then the
     final evaluation and the test frames. Each: s/step, the net's class,
     dtype and widths, K4 bf16 launched at least twice a training step and
     K4 f32 never, the losses finite, -O's last epoch mean under its first,
     the test frames written, and the last checkpoint reloaded into a
     fresh net equal to the trained one;
 11d. cli options: the training CLI's other command lines on that
     directory at the CLI's default widths (CLI_RUNS): `-O --ff --encoding
     tiledgrid --error_map --iters 96` (NeRFNetworkFF on a tiled grid; K4
     bf16 at least twice a step and K4 f32 never, the losses finite and
     the last 16 steps' mean under the first 16's, every view's error map
     moved from its ones), then its `--test` in fast (with the 256^3 mesh:
     K4 launched 8 times in the probe, one 2,097,152-row block held to
     the plain chain at TOL_K4, the vertex and face counts, the probe's
     and the iso-surface's seconds), guided and scout (K4 in every frame,
     never its plain version, finite frames, each mode's PSNR beside the
     staged evaluation's, no bar); `--tcnn -O --iters 96` (no K4 launch,
     the losses falling, the checkpoint reloaded bit-equal) and its
     `--test` (staged frames and the mesh, no K4); `--bg_radius 4 --iters
     8` (the background net's 2-D table moved); `--ff --encoding None
     --iters 8` (K4, the color net, in every step). `--cli-options` runs
     it alone;
 12. kernels K6, K7: the row gathers at every shape of the gather probe's
     sections E and F and at a ragged M, bit-exact against table[idx] (K7
     for each nslot), with kernel, plain, library (index_select) and bound
     times; then at K7's shapes, nslot 16, the K7 designs of PERF.md
     (scripts/k7_variants.py: one issuing lane or every lane, 2048 rows a
     block or K7's geometry), K7 itself, K6 and index_select, each
     bit-exact, one JSON line per shape;
 13. gather probe: the port's scripts/bench_gather.py --quick, all
     sections, with the counts at 0 before and read after (the path that
     runs K6 and K7);
 14. bench: the port's bench (nerfsafetyvalidation_tpu_torch/bench.py,
     bench.py's gate) with BENCH_SCENES=spheres, as a user runs it, with
     the counts at 0 before and read after and every call of K1's, K3's
     and K4's plain versions counted: its gate passes; all six modes
     (baked_h160_ak8, baked_h160, baked_h192, baked through K1 at H = 160,
     160, 192, 256; guided and fast through K3) and both reference lines
     (through K4) lie within 0.15 dB of BENCH_r05, mean and min; K1 ran at
     each width, K3 and K4 ran, and no plain version was called;
 15. rollouts: the batched rollout engine (validation/batched.py
     FullBatchedRolloutEngine) as validate.py --batched_rollouts builds
     it, on envConfig.json's dynamics and disturbances (12 steps of 1/6 s,
     hover actions), 16 sims, 100x100 observations, from the state whose
     observation camera is held-out pose 0, over the SDF of the teacher's
     density on the scene's box at 40 cells a metre: a Monte Carlo run of
     each observation path, `scout` (the 160x6 student over the teacher's
     occupancy, K1), `fast` and `guided` (the teacher, K3), `uniform` (the
     ref net, 64 samples a ray, K4), with the same standard normals: its
     kernel launched and no plain version called, sigma_d finite and >= 0,
     the reward finite, step 0 on the same points on every path; the
     start's observation through the kernel and through the plain field
     (image at the frames' bounds, the UQ's inputs at TOL_UQ_STATS);
     rollouts/s, s per sim-step, the collision rate;
 16. rollouts cem: two CEM iterations (16 sims, 5 elite) on `scout`, the
     27-column CSV written to a temporary directory, its rows checked to
     stop at each sim's first collision;
 17. bench_rollouts: the port's bench_rollouts, its two JSON lines;
 18. sigma clipping: the shaded samples whose sigma pre-activation s0
     exceeds 15 (where K1 and K3 clip it) through the unclipped plain
     chain, in pose 0's 800x800 `fast` and `baked_h160` frames and in each
     rollout path's observation, and S_d2 and sigma_d through the kernel
     route and through that chain;
 19. validate --ff MC, validate --ff CEM: the port's validate CLI
     (`validate.main`, --batched_rollouts) as a user runs it, each in a
     temporary working directory holding envConfig.json (16 and 10 sims;
     its epochs, iterations and camera kept), the SDF of the phase's own
     net at the simulator's grid (validation/utils/sdf.py) and the
     checkpoint of the main_nerf -O --ff run (NeRFNetworkFF, bf16), on a
     spheres directory whose test view (the intrinsics) is 800^2, as the
     camera is (VALIDATE_RES), at 64 samples a ray, Python's `random`
     seeded 0: the restarts of the CLI's "Path not found" loop (at most
     5), A*'s occupied share of its 20^3 grid and the path's length,
     learn_init's seconds and first and last cost (which must fall), K4's
     launches in A*'s 100^3 probe, in learn_init and in the observations
     (each at least one; the plain version never), rollouts/s, the
     collision rate, sigma_d's range and the CSV's rows (the MC CSV's 23
     columns; the CEM CSV's 27, each sim's rows stopping at its first
     collision); then K4 against its plain chain at the learned plan: the
     planner's cost and its gradient in the knots (TOL_K4's sigma bound),
     its collision term and that term's gradient (TOL_K4_COLLISION; a
     planted K4 error must fail it), and the start's observation (the
     frames' image bounds, the UQ's inputs at TOL_UQ_STATS);
 20. validate --closed_loop: the same on an unfused hash-grid net, 4
     sims: the CLI's default float32 NeRFNetwork, trained by `main_nerf
     --cuda_ray --iters 192` on the same directory ("validate nets", which
     also loads bench_assets/refbb.ckpt into that net and prints the share
     of A*'s grid it leaves occupied: too much for a path, see
     VALIDATE_UNFUSED), envConfig's 100 estimator
     iterations and 250 replan epochs a step, 800^2 camera, 32^2 interest
     grid, the plan's first CL_STEPS steps: s per sim-step, the
     estimate's, replan's and UQ's milliseconds a population step, the
     mean distance between the estimated and the true position, finite
     estimates and rewards, no K4 launch;
 21. the refusals: --closed_loop --ff, --batched_obs_render guided
     without --fast_render, and --r --ff, and on the sequential path --ff,
     each exit with their message within seconds, before anything loads;
 22. sequential MC: the port's validate CLI without --batched_rollouts,
     as a user runs it, envConfig.json as shipped (NerfSimulator, Monte
     Carlo, the Gaussian UQ, the 800^2 camera, the estimator's 1,024-pixel
     batch and 100 Adam steps, the planner's 1000 + 250 epochs), --camera
     nerf, on phase 20's net (the CLI's default float32 NeRFNetwork: no
     kernel on this path in either package), cut to SEQ_SIMS sims, each
     sim's first SEQ_STEPS steps and 64 samples a ray: the seconds per
     sim-step of the NeRF camera's
     capture, the observation render, the UQ's render and fit, the
     estimator's fit, its Hessian, the replan and the SDF check; the
     estimate's distance from the true position at each step; the CSV's
     rows (24 columns), the collisions, the interest-point detector,
     sigma_d and the reward; every tensor of the fit and the Hessian on
     the card, every estimate and covariance finite, measurement_fn's
     value and gradient on the card against the CPU's from the same
     inputs (TOL_MEAS), no K4 launch;
 23. sequential CEM: the port's CrossEntropyMethod on that simulator, m =
     2, m_elite = 1, kmax = 1 (SEQ_CEM), trajectories of SEQ_STEPS steps
     (its 27-column CSV, each sim's rows stopping at its first
     collision), the same numbers;
 24. simulate: `simulate.main` as a user runs it (envConfig.json as
     shipped, --camera nerf, 64 samples a ray; when A* finds no path
     between envConfig's start and goal in this net, the MC phase's path,
     said so), A*'s knots thinned to SIM_KNOTS: the seconds per step of
     the capture, the fit, the Hessian and the replan, the estimate's
     distance from the truth a step;
 25. kernel K4 grouped: the in-scan Laplace fits' mode (one weight set a
     group) against its plain version at 16 groups x 256 rows of the FF
     sigma net 32-64-64-16 (seeded), at a ragged 5 x 200, and at 3 x 40
     of a narrow 24-48-8 net with contiguous weights; each group
     bit-equal to the single mode on its own weights; 20 reruns
     bit-identical; the weights' gradients the recompute's, bit for bit;
     one CUDA kernel a call (the profiler's count: each block packs its
     group's image, no pack kernel); kernel, plain, library (a bf16
     torch.bmm chain) and bound times;
 26. uncertain --ff: `uncertain -O --ff` as a user runs it, on the
     main_nerf -O --ff checkpoint and a spheres directory of
     UNCERTAIN_VIEWS training views and an 800^2 test view, 64 samples a
     ray, envConfig's uq_method
     the Laplace approximation, then the Gaussian: K4 in each view's
     staged render and at least once an Adam step of the MAP fits on all
     640,000 points, no plain call; the fit's -log posterior and its
     gradient through K4 against the plain chain (TOL_LAPLACE); trace
     and rmv, finite in every view, the heat map; seconds by part
     (render, fits, LM, the inverse);
 27. validate --ff MC laplace: phase 19's setup with envConfig's Laplace
     (the engine's knobs: 100 Adam steps, 256 points, 3 perturbations, 20
     LM steps): the grouped K4 launched, no plain call; the start's
     in-scan Laplace of 16 sims through the kernel and the plain chain:
     the -log posterior and its gradient at the drawn theta (TOL_LAPLACE),
     the LM from one MAP theta on both routes (lmbda and the stops equal,
     x and g within TOL_LAPLACE_LM), trace and rmv printed; at least
     LAPLACE_FINITE of the in-scan fits and of the rewards finite, and
     every fit that is not explained (`laplace_finite_checks`);
     rollouts/s; seconds in the observations, fits and LM;
 28. Laplace without a kernel: the sequential MC with the Laplace UQ (1
     sim, SEQ_STEPS steps, phase 20's net, envConfig as shipped but the
     uq_method, --camera nerf, 64 samples; seconds per sim-step by part;
     at least LAPLACE_FINITE of its rmv finite), and validate --closed_loop
     --closed_loop_uq laplace (4 sims, CL_STEPS steps; the fits' and
     rewards' finite shares and their explanation as in 27); no K4;
 29. cell layout: the cell table (ops/hash_encoding.py build_cell_table)
     of phase 20's net (float32) and of phase 19's (--ff, bf16) built on
     the card and on the CPU, bit-equal; the cell encode of 131,072
     seeded points on the card against the CPU's, and against the corner
     encode on the dense levels (TOL_CELL); the table's MB, the build's
     ms, the cell and corner encodes' device ms;
 30. validate --ff --fast_render MC: phase 19's setup (16 sims, the plan's
     steps) with --fast_render, in a directory holding phase 19's pose
     cache (reset skips learn_init), with the default observation
     (uniform, through run_grid over the occupancy grid) and with
     --batched_obs_render scout: K4 launched in the observations, the
     refresh and A*, its plain version never; rollouts/s, the collision
     rate, sigma_d's range, the CSV's rows, the grid's occupied share and
     the start's observation (its UQ inputs, its share of pixels that are
     not background), and the same observation from the test view's pose,
     which must shade some pixels;
 31. sequential MC --fast_render: phase 22's run (1 sim, FR_SEQ_STEPS
     step, phase 20's float32 net, its pose cache) with --fast_render: seconds
     per sim-step by part, render_fn's (render_grid_staged on the net's
     cell view) seconds a frame and rays/s, no K4 launch; the test view's
     PSNR through the fast frame beside the staged frame's; 4 chunks of
     that frame on the card and on the CPU (TOL_GRID_CPU);
 32. validate --r --camera nerf: phase 22's Monte Carlo CSV and phase
     23's cross-entropy CSV (--iter 1: from its second simulation on)
     replayed on a BlenderSimulator (the replay
     CSV's rows, the eight counts, counts.pkl, both confusion PNGs
     decoded and their counts); envConfig's BlenderSimulator through
     --batched_rollouts (the core engine, its 4-column CSV);
 33. distill: bench.py's cold student path (models/bake.py through
     flagship.py) on the phase-3 teacher, served through K3: the 160x6
     student at full width and batch, DISTILL_STEPS distill steps of
     32,768 points and FT_STEPS fine-tune steps of 8,192 rays x 16
     window samples from a generator seeded DISTILL_SEED: both losses
     finite and falling (the mean of each phase's last LOSS_WINDOW steps
     under its first LOSS_WINDOW steps'), K3 launched in every step of
     both phases, the student's pkl (assets.save_student) reloaded
     bit-equal, the served student through K1 on 131,072 rows against the
     trained unfused chain (TOL_K1), pose 0 at 800x800 in baked_h160_ak8
     through K1 (its PSNR printed, no bar: a cut schedule), s/step and
     the share of the teacher's rows whose s0 K3 clipped at +-15.
     `--distill` runs it alone;
 34. f32: the float32 kernels and K3's backward (`--f32` runs it alone):
     K3 f32 (csrc/sigma_color.cu's FFMA kernel) on phase 5's two tiles
     (262,144 and 2,097,152 rows) of the committed teacher in float32
     against its plain version at TOL_F32 (TF32 off), 20 reruns
     bit-identical, with kernel (warm and cold), plain, library (the f32
     torch.matmul chain) and bound times; K3's backward in bf16 and f32 at
     262,144 rows with a seeded cotangent, outside inference mode and with
     anomaly detection off: one forward launch, and the gradients of enc,
     sh and the five weights equal to the plain recompute's VJP bit for
     bit; the f32 teacher's fast and guided frames on the four poses (K3
     f32 in every frame, K3 bf16 never, mean PSNR at the 28-dB bar, the
     gap to phase 6's bf16 frames, pose 0 against its plain frame); K1 f32
     (csrc/points_mlp.cu's 3xTF32 kernel) on phase 4's 131,072 rows
     through the committed 160-, 192- and 256-wide students in float32 at
     TOL_F32, 20 reruns bit-identical, and at TOL_F32 of its 3xTF32
     arithmetic in plain PyTorch, which a 2xTF32 control must miss (K2 f32
     on the 160-wide student's rows at TOL_K2_F32 of both), the same four
     times and both bounds, with the weight stream's modelled L2 bytes a
     launch; the f32
     160x6 student's baked_h160_ak8 frames (K1 f32 in every frame, K1 bf16
     never, the bar, the gap to phase 7's, pose 0 against its plain
     frame); then the teacher trained fused (fused=True) from a seeded init
     at TRAIN_CFG's widths on phase 11's 48-view set, F32_TRAIN_STEPS steps
     in bf16 and in f32, the f32 run with fold_warmup_scale F32_FOLD_WARMUP
     before F32_WARMUP: K3 of the run's dtype launched every step and the
     other never, K5 once forward and once backward a step (every launch's
     fold scale recorded: the warm-up steps' at F32_FOLD_WARMUP), the loss
     finite and falling; and one step through K3 against one through its
     plain forward from the trained parameters and the same draws
     (TOL_K3_STEP).
Phase 22's population is cut to 1 sim (SEQ_SIMS), the sequential phases
(22, 23, 28) to each sim's first SEQ_STEPS steps, phase 24's plan to
SIM_KNOTS knots, phase 31 to FR_SEQ_STEPS, the closed-loop ones (20,
28) to CL_STEPS, phase 27 to LAPLACE_MC_STEPS, phase 26 to UNCERTAIN_VIEWS
views and phase 32's cross-entropy replay to its second simulation, to
make room for 25-34 and 11d within the time limit on a slower host.
Every mode's mean and min PSNR must lie within 0.15 dB of its BENCH_r05
anchor (the staged modes have no JAX record; their PSNR is printed).
Every launch count is set to 0 just before each frame phase, the refresh,
the training, each main_nerf run (in 11d each test frame and mesh probe
too), K2's path, the probe, the bench, each
rollout phase, each validate run, the distillation (K3 before it,
K1 before its frame), and in phase 34 each kernel check, frame, training
run and step, and read just after. The
configurations are `nerfsafetyvalidation_tpu_torch/flagship.py`'s. Then one JSON line listing
every kernel, the nvidia-smi line, and the result line.

Every failed check raises and ends the run with a non-zero exit; without a
CUDA device the script fails before printing anything.
"""

import contextlib
import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the JAX package's spheres PSNR (mean, min) of each mode, BENCH_r05.json;
# the reference backbone is scored on pose 0 alone (bench.py:808)
BENCH_R05 = {"fast": (31.08, 30.75), "guided": (30.74, 30.41),
             "baked_h160_ak8": (30.04, 29.97),
             "baked_h160": (30.17, 30.00), "baked_h192": (30.20, 29.85),
             "baked": (30.10, 29.79),
             "ref_backbone": (27.06, 27.06),
             "ref_backbone_ml8": (26.64, 26.64)}
# The port computes the same function from the same weights, so a mode
# further than this from its anchor is a fault (PERF.md section 2)
GAP_BAND = 0.15
K1_ROWS = 8192 * 16         # one K=16 tile of the student frame
K3_RAYS, K3_K = 16384, 16   # one fine tile of the guided frame
K4_RAYS, K4_K = 131072, 16  # one shaded tile of the marched frame
PSNR_BAR = 28.0             # the spheres gate of bench.py (not the ref line)
# The training phase: bench.py's schedule cut to 3 epochs of the 48 views
# (144 steps, lr decaying over them) with the budget phase switch moved
# from step 512 to 64, so that the run crosses it and the partial refresh
# (steps 80, 96, ...). Only the schedule is cut; widths, rays per step,
# budgets and the refresh interval are bench.py's.
TRAIN_STEPS, TRAIN_WARMUP = 144, 64
# the last 16 steps' mean loss must be under this fraction of the first
# 16 steps': measured 0.170 (NVIDIA H100 80GB HBM3, 700 W; PERF.md
# section 6), bound about twice that
LOSS_FALL = 0.35

# K4's forward and gradients are checked at the rows of a marched training
# step (4,096 rays x a budget of 16 after the warm-up: 65,536; x 24 before
# it: 98,304) and of a uniform one (4,096 x 512)
K4_GRAD_ROWS = (65536, 98304, 2097152)
# the reference training CLI (main_nerf) on the spheres set written as a
# blender directory (48 training views at 200x200, 2 validation, 4 test):
# -O --ff for 4 epochs (the march) and --ff for 8 iters, one whole epoch
# (512 uniform samples a ray), both at the CLI's defaults but --bound 1
# --scale 1 (the scene's box). --ff builds NeRFNetworkFF, bf16 with or
# without -O: both runs launch K4's bf16 kernel forward and backward, at
# the FFMLP widths (FF_WIDTHS), and never its f32 one
MAIN_NERF_RUNS = (("-O --ff", ["-O", "--ff", "--iters", "192"], "K4",
                   "K4 f32"),
                  ("--ff", ["--ff", "--iters", "8"], "K4", "K4 f32"))
FF_WIDTHS = ([32, 64, 64, 16], [32, 64, 64, 64, 3])
BARRED = ("fast", "guided", "baked_h160_ak8")

# Kernel vs plain, both bf16 with f32 sums. The two sum in different
# orders, so an activation now and then rounds to the neighbouring bf16
# value and the difference runs on through the later layers. For K1,
# changing only the sums' precision (f32 -> f64) in the plain chain, on
# 131,072 rows with this student, moved rgb by 0.058 at most (1.4e-5 on
# average) and sigma by 15% of max(|sigma|, 1) at most (5.6e-6 on
# average). The bounds below are about 3x those maxima and 15x those
# means; a wrong kernel misses the means by orders of magnitude.
TOL_K1 = dict(rgb=(0.15, 2e-4), sigma=(0.4, 1e-4))
# K2 in f32 against its plain version in f32 (cuBLAS's f32 products, TF32
# off): every layer sums up to 256 products in another order, each rounding
# at most 2^-24 of the running sum, and the ReLU chain carries the
# difference on; sigma = exp(s) turns s's absolute error into a relative
# one. Stated before the first run on the card, for an FFMA kernel: rgb
# (max 1e-4, mean 1e-6), sigma relative (max 1e-3, mean 1e-5), some 10x
# above a 6-layer random walk of 2^-24 steps at these widths. The 3xTF32
# kernel is held to the same bounds: each of its products is within about
# 2^-21 of f32's.
TOL_K2_F32 = dict(rgb=(1e-4, 1e-6), sigma=(1e-3, 1e-5))
# K3 (bounds: max, mean): the same f32 -> f64 experiment on its plain chain
# at its 262,144-row tile, printed beside its errors, moved rgb by 8.3e-4 at
# most (3.4e-8 on average) and sigma by 0.36% of max(|sigma|, 1); the
# kernel measured 2.3e-3 / 3.5e-8 on rgb and 0.38% / 1.3e-7 on sigma (NVIDIA
# H100 80GB HBM3). Bounds: about 4x the maxima, 10-30x the means.
TOL_K3 = dict(rgb=(1e-2, 1e-6), sigma=(1.5e-2, 2e-6))
# K4 (bounds on |kernel - plain| / max(|plain|, 1): max, mean), per launch:
# the sigma net's [N, 16] output and the color net's [N, 3] pre-sigmoid
# output, both rounded to bf16 as the TPU kernel rounds them. At one fast
# tile of the reference backbone (2,097,152 rows) the kernel measured
# 7.8e-3 / 5.5e-8 (sigma net) and 7.8e-3 / 1.3e-7 (color net): one output
# on the neighbouring bf16 value now and then; the plain chain with f64
# instead of f32 sums moves them by 7.8e-3 / 3.5e-8 and 7.8e-3 / 5.4e-8
# (NVIDIA H100 80GB HBM3). Bounds: about 3x the maxima, 15-20x the means.
TOL_K4 = dict(sigma=(2.5e-2, 1e-6), color=(2.5e-2, 2e-6))
# The planner's collision term through K4 against the plain chain, per
# knot relative to its largest, and its gradient in the knots relative to
# the largest component: 1e6 times the mean over 500 body points of
# sigma^2 times the speed. At TOL_K4's mean rate a sigma-net output lands
# on the neighbouring bf16 value about once in 140,000 rows, and the term
# reads (S+3) x 500 (5,500 at the smoke's plan), so it mostly sees f32 sum
# order; one such flip at the densest point with |log sigma| < 4 moves
# sigma^2 by <= 3.2%. Bound: TOL_K4's. The planted error below (sigma 3%
# high, the term 6.2%) must fail it; the whole cost, which 1000 fz^2
# dominates, moves 0.2%. Measured: the term equal, its gradient 5.4e-3;
# planted 6.2e-2 / 6.9e-2 (NVIDIA H100 80GB HBM3).
TOL_K4_COLLISION = 2.5e-2
PLANTED_K4_LOG_SIGMA = 0.03
# K4 in f32 against its plain version (rtol, atol): the JAX package's own
# tolerance of its f32 kernel against the f32 chain (tests/
# test_fused_mlp.py:263-269). Three tf32 products a term (each ~2^-22 of
# it) summed in f32 against cuBLAS's f32 products (TF32 off) in another
# order: a few float32 steps of each layer's sums, ~1e-6 relative.
TOL_K4_F32 = (5e-4, 1e-5)
# K4 f32 also at other row counts and chains, seeded, against its plain
# version at TOL_K4_F32: (widths, rows): the hash-grid nets' builds at
# ragged row counts; the run-time dispatch's narrow build (widths up to
# 64: [5] * 9, [1, 3], [33, 100, 7] padded to 128, ...) and its wide one
# (up to 128) with the weights resident, and with them loaded a layer at a
# time ([128] * 9); a last layer on the tensor cores that is 1 wide
K4_F32_ODD = (([32, 64, 16], 1), ([32, 64, 16], 129),
              ([31, 64, 64, 3], 127), ([31, 64, 64, 3], 262149),
              ([5] * 9, 1001), ([1, 3], 1000), ([33, 100, 7], 999),
              ([31, 128, 3], 777), ([64, 128, 128, 128, 16], 513),
              ([128, 1], 256), ([128] * 9, 300))
# A staged chunk through the kernel against the same chunk through the
# plain field: image (max, mean) abs, the last chunk's rgbs max abs and
# sigmas max |diff| / max(|sigma|, 1). f32: the two sum in other orders,
# ~1e-6 relative on each MLP output; sigma = exp(s) turns s's absolute
# error (|s| up to ~12: ~1e-5) into a relative one; bounds about 10x that.
# bf16: the bf16 frames' bounds (TOL_IMG_MAX / MEAN) and K1's per-sample
# ones (TOL_K1: one activation on the neighbouring bf16 value).
TOL_STAGED = {"K4 f32": dict(image=(1e-4, 1e-6), rgbs=1e-4, sigma=1e-4),
              "K4": dict(image=(0.05, 1e-4), rgbs=0.15, sigma=0.4)}
# Frame through a kernel vs frame through the plain version (same state).
# For K1 the f32 -> f64 change moved a 400x400 frame by 0.0067 at most and
# 1.7e-6 on average. Measured kernel vs plain frames, pose 0: fast 1.2e-3 /
# 2.6e-8, guided 2.1e-2 / 1.2e-6 (the march prepass's depths move the
# windows), student 1.6e-2 / 2.7e-6, ref_backbone 4.3e-3 / 6.0e-8,
# ref_backbone_ml8 1.3e-3 / 3.7e-8.
TOL_IMG_MAX, TOL_IMG_MEAN = 0.05, 1e-4
# K5's backward against its library call (index_add_, which sums each dV
# value's <= 8 terms one by one in the cotangent's dtype, in its own order):
# up to 8 roundings of partial sums no larger than max |dV|, 8 * 2^-9 in
# bf16 and 8 * 2^-24 in f32 of it; bounds twice that.
TOL_K5_LIB = {"torch.bfloat16": 2 ** -5, "torch.float32": 2 ** -20}
# One training step through "foldrow_pallas" (K5) against one through
# "foldrow" (the slice-stack under autograd) from the same parameters and
# draws. The forward folds are the same copy, so the losses and every
# gradient but the pyramid's are equal (checked); the pyramid's gradient goes through
# the fold's backward, which K5 sums as the TPU kernel does (two f32 half
# sums, each rounded to bf16) and autograd sums term by term in bf16, so
# it differs by bf16 roundings. (The gathers' scatter-add backward sorts
# its indices and sums each row's duplicates in a fixed order: a rerun of
# one route gives the same gradients, bit for bit.) Adam's first step
# moves each entry by lr times the sign of its gradient, so an entry whose
# gradient is near zero may move the other way: 2 lr apart. Measured
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): pyramid gradients
# 4.1e-4 to 4.4e-3 of their largest apart, updates apart on 2.1e-4 to
# 6.4e-4 of the entries, by 2 lr at most. Bounds: TOL_ROUTE_GRAD of the
# largest gradient; 2 lr on a share TOL_ROUTE_FRAC of the entries.
TOL_ROUTE_GRAD, TOL_ROUTE_FRAC = 2e-2, 3e-3

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, float32
# outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# cycles a second of torch.cuda._sleep's spin (about the H100's SM clock)
SLEEP_HZ = 1.98e9
# K3 and K4 rerun on their tiles this many times, each rerun bit-identical
# to the first call: a race in a ring shows as rows that differ (PERF.md
# section 6)
RERUNS = 20
# the H100's L2: cold timings rotate over copies of a call's inputs that
# together hold at least 1.5x this
L2_BYTES = 50e6
# K1 at its other widths (H, rows): seeded weights, std sqrt(2 / fan-in)
K1_WIDTHS = [(192, 8192), (256, 8192)]
# the gather probe's kernel shapes (scripts/bench_gather.py sections E, F):
# K6 (R, C, M); K7 (R, C, M, the nslots it runs)
K6_SHAPES = [(2 ** 13, 64, 2 ** 19), (2 ** 14, 64, 2 ** 19),
             (2 ** 13, 32, 2 ** 19)]
K7_SHAPES = [(2 ** 19, 64, 2 ** 18, (4, 16, 32)),
             (2 ** 15, 256, 2 ** 17, (16,)), (2 ** 15, 512, 2 ** 17, (16,))]
NSLOTS = (4, 16, 32)
RAGGED_M = 2 ** 18 - 1000   # not a multiple of the 2048-row tile
# The distillation phase (models/bake.py through flagship.py): the
# headline's 160x6 student at full width and batch (32,768 points a
# distill step, 8,192 rays x K = 16 a fine-tune step) with bench.py's
# 24,000 + 12,000-step schedule cut to these steps (the cosine decays
# over the cut schedule), from a generator seeded DISTILL_SEED; each
# phase's mean loss over its last LOSS_WINDOW steps must lie under its
# first LOSS_WINDOW steps'.
DISTILL_STEPS, FT_STEPS, DISTILL_SEED = 200, 50, 0
DISTILL_HIDDEN = 160
LOSS_WINDOW = 20


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"[{self.name}] start", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            print(f"[{self.name}] done in "
                  f"{time.perf_counter() - self.t0:.2f} s", flush=True)
        return False


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of fn() over reps back-to-back calls. The
    card first sleeps about twice as long as the host takes to queue the
    calls, so that they run back to back on the device: a kernel faster
    than its wrapper's Python is timed, not the wrapper."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2.0 * reps * host, 1.0) * SLEEP_HZ))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(torch, make_call, in_bytes, reps):
    """Mean device milliseconds of one call with inputs that are not in L2:
    make_call() copies the inputs and returns a call on the copy; the calls
    on enough copies to hold 1.5x the L2 (3 at 25 MB of inputs) run in turn,
    so each finds its inputs evicted by the others. Returns (ms,
    copies)."""
    copies = max(2, -(-int(1.5 * L2_BYTES) // int(in_bytes)))
    calls = [make_call() for _ in range(copies)]
    turn = [0]

    def next_call():
        turn[0] = (turn[0] + 1) % copies
        return calls[turn[0]]()
    return cuda_ms(torch, next_call, reps), copies


def reruns_equal(torch, fn, first):
    """How many of RERUNS more calls of fn() return exactly `first` (a tuple
    of tensors): a kernel that reads a ring stage the copy engine is
    already overwriting shows as a rerun that differs."""
    same = 0
    for _ in range(RERUNS):
        out = fn()
        same += all(torch.equal(a, b) for a, b in zip(out, first))
    return same


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """The least time the card could take: (ms, 'operations' | 'bytes')."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def compare(torch, name, got, want, tol):
    """Kernel (sigma, rgb) vs plain (sigma, rgb): prints and checks the
    errors against tol {'rgb': (max, mean), 'sigma': (max rel, mean rel)};
    returns the largest absolute error."""
    s_k, c_k = got
    s_p, c_p = want
    n = s_p.shape[0]
    check(s_k.shape == (n,) and c_k.shape == (n, 3), f"{name} output shapes")
    check(bool(torch.isfinite(s_k).all() and torch.isfinite(c_k).all()),
          f"{name} outputs are not all finite")
    rgb_err = (c_k - c_p).abs()
    sig_abs = (s_k - s_p).abs()
    sig_rel = sig_abs / s_p.abs().clamp(min=1.0)
    print(f"{name} vs plain on {n} rows: rgb max abs "
          f"{float(rgb_err.max()):.3e} mean {float(rgb_err.mean()):.3e};"
          f" sigma max rel {float(sig_rel.max()):.3e} mean "
          f"{float(sig_rel.mean()):.3e} (max abs {float(sig_abs.max()):.3e}"
          f" at sigma up to {float(s_p.max()):.3e})")
    for what, err in (("rgb", rgb_err), ("sigma", sig_rel)):
        t_max, t_mean = tol[what]
        check(float(err.max()) <= t_max and float(err.mean()) <= t_mean,
              f"{name} {what} disagrees with the plain version (tolerance "
              f"max {t_max}, mean {t_mean})")
    return max(float(rgb_err.max()), float(sig_abs.max()))


def spheres_views(dev):
    """The four held-out poses of the spheres scene at 800 x 800 (F.RES):
    [(rays_o, rays_d, ground truth [RES, RES, 3] on white)]."""
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch.data.synthetic import (camera_rays,
                                                               trace_scene)
    views = []
    for pose in F.holdout_poses():
        o_np, d_np = camera_rays(pose, F.intrinsics(), F.RES, F.RES)
        gt_rgb, gt_alpha, _ = trace_scene(o_np, d_np, scene="spheres")
        gt = gt_rgb * gt_alpha[..., None] + (1.0 - gt_alpha[..., None])
        views.append(F.pose_rays(pose, dev) + (gt,))
    return views


def k1_points(torch, scfg, dev):
    """Phase 4's K1 rows: K1_ROWS points on pose 0's rays, spread over the
    frame, uniform in depth over each ray's [near, far] inside the box.
    Returns (x [K1_ROWS, 3], the rays' directions [K1_ROWS, 3])."""
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch.models.renderer import aabb_of
    from nerfsafetyvalidation_tpu_torch.ops.ray_ops import near_far_from_aabb
    o, d = F.pose_rays(F.holdout_poses()[0], dev)
    pick = torch.arange(K1_ROWS, device=dev) * (o.shape[0] // K1_ROWS)
    o, d = o[pick], d[pick]
    near, far = near_far_from_aabb(o, d, aabb_of(scfg, dev), scfg.min_near)
    inside = far > near
    near = torch.where(inside, near, scfg.min_near)
    far = torch.where(inside, far, 4.0)
    g1 = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand(K1_ROWS, generator=g1, device=dev)
    x = torch.clamp(o + (near + u * (far - near))[:, None] * d,
                    -scfg.bound, scfg.bound).contiguous()
    return x, d


def k3_points(torch, teacher, state, views):
    """Phase 5's two K3 tiles as (points [R, 3], directions [R, 3]):
    "guided", one guided fine tile: the 16,384 rays at the centre of pose 0,
    16 uniform samples in [t_hit -/+ 6 cells] around the surface the
    marched frame finds (the ray's [near, far] where it finds none); and
    "fast", the samples pose 0's marched frame hands the teacher in its
    first K=16 tile. "hit": the guided tile's rays that hit."""
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch.models.renderer import (
        aabb_of, render_frame_fast)
    from nerfsafetyvalidation_tpu_torch.ops.ray_ops import near_far_from_aabb
    tcfg, dev = teacher.cfg, views[0][0].device
    o, d, _ = views[0]
    mid = o.shape[0] // 2 - K3_RAYS // 2
    o, d = o[mid:mid + K3_RAYS], d[mid:mid + K3_RAYS]
    pre = render_frame_fast(teacher, state, o, d,
                            **dict(F.MODES["fast"]["frame"], tile=K3_RAYS))
    near, far = near_far_from_aabb(o, d, aabb_of(tcfg, dev), tcfg.min_near)
    hit = pre["weights_sum"] > 0.1
    t_hit = pre["depth_abs"] / pre["weights_sum"].clamp(min=0.1)
    margin = 6.0 * 2.0 * tcfg.bound / tcfg.grid_size
    ta = torch.where(hit, torch.maximum(t_hit - margin, near), near)
    tb = torch.where(hit, torch.minimum(t_hit + margin, far), far)
    jj = torch.arange(K3_K, device=dev) + 0.5
    z = ta[:, None] + (tb - ta)[:, None] / K3_K * jj[None, :]
    xyz = torch.clamp(o[:, None] + z[..., None] * d[:, None], -1, 1)
    seen = []

    class Capture:
        cfg = tcfg

        def __call__(self, x, d, plain=False):
            seen.append((x, d))
            return teacher(x, d, plain=plain)

    F.render("fast", {"teacher": Capture()}, state, *views[0][:2])
    tiles = [xd for xd in seen if xd[0].shape[0] == K4_RAYS * K4_K]
    check(len(tiles) > 0, "pose 0's fast frame has no K=16 tile")
    return {"guided": (xyz.reshape(-1, 3),
                       d[:, None].expand(K3_RAYS, K3_K, 3).reshape(-1, 3)),
            "fast": tiles[0], "hit": int(hit.sum())}


def popcount(torch, bytes_u8):
    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         device=bytes_u8.device)
    return int(table[bytes_u8.long()].sum())


# The rollout phases (nerfsafetyvalidation_tpu_torch/validation/batched.py)
# on the spheres assets, as flagship.rollout_engine sets them up: the SDF of
# the teacher's density over the scene's box at the JAX package's 40 cells
# a metre (validation/utils/sdf.py; its default extents are Stonehenge's).
SDF_BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
# each path's kernel (the nets: flagship.ROLLOUT_NETS)
ROLLOUT_KERNELS = {"scout": "K1", "fast": "K3", "guided": "K3",
                   "uniform": "K4"}
CEM_RUN = dict(m=16, m_elite=5, kmax=2)
# One observation through the kernel vs the plain field (same state, same
# settings): the image at the frames' bounds (TOL_IMG_MAX / MEAN); the
# UQ's five inputs (S_c2d2, S_cd, mean image, mean and std of sigma),
# relative. Stated before the first run on the card: the kernels round as
# their plain versions do and sum in other orders, a per-sample error of
# ~1e-5 on average (TOL_K1 / TOL_K3 / TOL_K4 means) that the sums over
# 10^5-10^6 slots average down; bound 1e-3.
TOL_UQ_STATS = 1e-3
E15 = float(np.exp(15.0))   # sigma where the kernels clip s0 at 15


class S0Count:
    """A field that shades 1 where `net`'s sigma exceeds e^15 (its s0 > 15;
    everywhere with `every`) and 0 elsewhere, rgb 1: a frame rendered
    through it with return_moments has S_d = the number of such slots
    among those the frame shades (masked slots count 0), on the windows
    and march of the real field (the guided frames get `net` as their
    prepass_net)."""

    def __init__(self, net, every=False):
        self.net, self.cfg, self.every = net, net.cfg, every

    def __call__(self, x, d, plain=False):
        sigma, rgb = self.net(x, d)
        hit = sigma.new_ones(sigma.shape) if self.every \
            else (sigma > E15).to(sigma.dtype)
        return hit, rgb.new_ones(rgb.shape)


def cem_csv_rows_stop(rows, steps):
    """The 27-column CEM CSV: every row 27 fields; each (iteration, sim)'s
    rows are steps 0.. in order, stop at its first collision (or run all
    `steps`), and carry everCollided = whether one of them collided.
    Returns (rows, sims that collided)."""
    groups = {}
    for r in rows:
        check(len(r) == 27, f"a CEM CSV row has {len(r)} columns, not 27")
        groups.setdefault((r[0], r[1]), []).append(r)
    hits = 0
    for key, g in groups.items():
        coll = [r[25] == "True" for r in g]
        check([int(r[2]) for r in g] == list(range(len(g)))
              and not any(coll[:-1])
              and (coll[-1] or len(g) == steps)
              and all((r[26] == "True") == coll[-1] for r in g),
              f"the CEM CSV rows of {key} do not stop at the first "
              "collision")
        hits += coll[-1]
    return len(rows), hits


# The validate phases: the port's validate CLI (nerfsafetyvalidation_tpu_
# torch/validate.py) as a user runs it, each in a temporary working
# directory with envConfig.json (n_simulations cut), the SDF of the
# phase's own net (validation/utils/sdf.py at the simulator's 40 cells/m
# grid) and its checkpoint, on the spheres set written as a directory:
# (name, flags, stress test, sims, checkpoint: "ff" for the main_nerf -O
# --ff run's, "unfused" for VALIDATE_UNFUSED's). Every run draws 64
# samples a ray (the CLI's default is 512; the rollout phases' 64);
# envConfig's epochs, estimator iterations and 800^2 camera stay.
VALIDATE_STEPS = 64
VALIDATE_RUNS = (
    ("--ff MC", ["--ff"], "Monte Carlo", 16, "ff"),
    ("--ff CEM", ["--ff"], "Cross Entropy Method", 10, "ff"),
    ("--closed_loop", ["--closed_loop"], "Monte Carlo", 4, "unfused"))
# The closed loop's net: the CLI's default float32 NeRFNetwork, unfused.
# refbb.ckpt loads into it (--bound 1 --scale 1), but its march-trained
# density leaves 76.5% of A*'s 20^3 grid occupied (printed below), where a
# path rarely fits: at the smoke's seed A* found none in 6 draws. So the
# smoke trains one with main_nerf as the -O --ff run is trained, without
# --ff and fp16: 192 iters through the march (--cuda_ray), float32,
# unfused.
VALIDATE_UNFUSED = ["--cuda_ray", "--iters", "192"]
# The validate CLI reads the intrinsics of its dataset's test split, and
# the closed loop's interest pixels lie on envConfig's 800^2 camera: the
# phases read a spheres directory whose one test view is 800^2 (the
# reference's Stonehenge set is 800^2). With the 200^2 training set the
# pixels would lie up to 68 degrees off the axis on one side (its focal
# length is 278 px, cx 100).
VALIDATE_RES = 800
# command lines the port refuses (each a SystemExit before anything loads;
# the first two loop forever in the JAX CLI, the third ends in a traceback)
VALIDATE_REFUSALS = (
    ("--closed_loop --ff", ["--closed_loop", "--ff"], "--closed_loop --ff"),
    ("--batched_obs_render guided", ["--batched_obs_render", "guided"],
     "restart loop"),
    ("--r --ff", ["--r", "--ff"], "--r --ff"))
# and on the sequential path (without --batched_rollouts)
SEQUENTIAL_REFUSALS = (
    ("--ff (sequential)", ["--ff"], "--ff on the sequential path"),)
# the validate CLI's restart loop: a phase fails after this many restarts
MAX_RESTARTS = 5
# the closed-loop phases (20, 28) fly each sim's first CL_STEPS steps of
# the plan's 11: the depth cut that keeps the smoke inside its time limit
# on a slower host (the population stays); at least 2, so that a step
# flies on the previous step's estimate and replan
CL_STEPS = 2
# phase 27's open-loop Monte Carlo with the in-scan Laplace flies each
# sim's first LAPLACE_MC_STEPS of the plan's 11 actions, the same depth
# cut (the population and the fits' knobs stay)
LAPLACE_MC_STEPS = 6
BLENDER_TO_NERF = ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))


class Places:
    """Patches methods (name, class, attribute) so that each call adds its
    K4 launches and seconds (between device waits) to its place's name, and
    keeps the last object each was called on; `hooks[name]` = (before,
    after) run on that object outside the counted window. `restore()`
    undoes the patches."""

    def __init__(self, sync, fused_mlp, places, hooks=None):
        self.k4, self.s, self.last, self.saved = {}, {}, {}, []
        self.sync, self.fused_mlp, self.hooks = sync, fused_mlp, hooks or {}
        for name, cls, attr in places:
            orig = getattr(cls, attr)
            self.saved.append((cls, attr, orig))
            self.k4.setdefault(name, 0)
            self.s.setdefault(name, 0.0)
            setattr(cls, attr, self._wrap(name, orig))

    def _wrap(self, name, orig):
        def call(obj, *a, **k):
            before, after = self.hooks.get(name, (None, None))
            if before:
                before(obj)
            self.sync()
            n0, t0 = self.fused_mlp.LAUNCHES, time.perf_counter()
            try:
                return orig(obj, *a, **k)
            finally:
                self.sync()
                self.k4[name] += self.fused_mlp.LAUNCHES - n0
                self.s[name] += time.perf_counter() - t0
                self.last[name] = obj
                if after:
                    after(obj)
        return call

    def restore(self):
        for cls, attr, orig in reversed(self.saved):
            setattr(cls, attr, orig)


def _workdir(data_dir, stress, sims, **env_extra):
    env = json.loads((ROOT / "envConfig.json").read_text())
    env.update(n_simulations=sims, stress_test=stress, **env_extra)
    Path("envConfig.json").write_text(json.dumps(env))
    return [data_dir, "--workspace", "ws", "--bound", "1", "--scale", "1",
            "--seed", "0", "--batched_rollouts", "--num_steps",
            str(VALIDATE_STEPS)]


def load_cli_net(torch, argv, ckpt, entry="validate"):
    """The net the CLI builds for `argv`, the checkpoint `ckpt` copied to
    ws/checkpoints and loaded as the CLI loads it. Returns (net, opt)."""
    from nerfsafetyvalidation_tpu_torch.cli import apply_O_flag, build_parser
    from nerfsafetyvalidation_tpu_torch.config import network_config_from_opt
    from nerfsafetyvalidation_tpu_torch.models import make_network
    from nerfsafetyvalidation_tpu_torch.train.trainer import Trainer
    os.makedirs("ws/checkpoints", exist_ok=True)
    shutil.copy(ckpt, "ws/checkpoints/ngp_ep0001.ckpt")
    opt = apply_O_flag(build_parser(entry).parse_args(argv), entry)
    net = make_network(network_config_from_opt(opt), None, device="cuda",
                       opt=opt, trainable=True)
    Trainer(opt, net, workspace="ws", use_checkpoint=opt.ckpt, mute=True)
    return net, opt


def write_net_sdf(torch, argv, ckpt):
    """validation/utils/sdf.npy of the net `argv` loads from `ckpt`, through
    the CLI's density closure (validation/utils/sdf.py at the simulator's
    40 cells/m grid). Returns (the SDF, its seconds)."""
    from nerfsafetyvalidation_tpu_torch.validation.utils.sdf import build_sdf
    net, _ = load_cli_net(torch, argv, ckpt)
    rot = torch.tensor(BLENDER_TO_NERF, device="cuda")

    def density(pts):
        with torch.inference_mode():
            x = torch.from_numpy(pts).cuda() @ rot
            return net.density(x)["sigma"]
    os.makedirs("validation/utils", exist_ok=True)
    t0 = time.perf_counter()
    sdf = build_sdf(density, out_path="validation/utils/sdf.npy")
    return sdf, time.perf_counter() - t0


@contextlib.contextmanager
def open_loop_horizon(horizon):
    """The open-loop engine cut to the plan's first `horizon` actions (the
    smoke's depth cut of phase 27)."""
    from nerfsafetyvalidation_tpu_torch.validation.batched import (
        FullBatchedRolloutEngine)
    real = FullBatchedRolloutEngine.__init__

    def init(self, actions, *a, **kw):
        real(self, actions[:horizon], *a, **kw)
    FullBatchedRolloutEngine.__init__ = init
    try:
        yield
    finally:
        FullBatchedRolloutEngine.__init__ = real


@contextlib.contextmanager
def closed_loop_horizon(horizon):
    """The closed-loop engine cut to the plan's first `horizon` steps (the
    smoke's depth cut of the closed-loop phases)."""
    from nerfsafetyvalidation_tpu_torch.validation.closed_loop import (
        ClosedLoopBatchedEngine)
    real = ClosedLoopBatchedEngine.__init__

    def init(self, *, steps, **kw):
        real(self, steps=min(int(steps), horizon), **kw)
    ClosedLoopBatchedEngine.__init__ = init
    try:
        yield
    finally:
        ClosedLoopBatchedEngine.__init__ = real


def validate_phase(torch, V, data_dir, extra, stress, sims, ckpt, smi,
                   keep=None, **env_extra):
    """One validate CLI run on the card (see VALIDATE_RUNS; env_extra:
    envConfig.json's keys changed, e.g. uq_method); returns its numbers.
    With `keep`, the working directory is copied there after the run
    (the --fast_render phase reuses its pose cache).
    With the Laplace UQ (envConfig's, or --closed_loop_uq laplace) the
    fits' parts are timed, their grouped K4 launches counted, and every
    in-scan fit recorded: at least LAPLACE_FINITE of the fits and of the
    rewards must be finite, and every fit that is not must be explained
    (`laplace_finite_checks`: a fit from an overflowing random start is
    NaN, in the JAX package too, ROADMAP Queue 3)."""
    import random
    from nerfsafetyvalidation_tpu_torch.nav.planner import (
        Planner, planner_cost_terms)
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    from nerfsafetyvalidation_tpu_torch.validation.batched import (
        FullBatchedRolloutEngine)
    from nerfsafetyvalidation_tpu_torch.validation.closed_loop import (
        ClosedLoopBatchedEngine)
    from nerfsafetyvalidation_tpu_torch.validation.simulators import (
        NerfSimulator)

    old, work = os.getcwd(), tempfile.mkdtemp()
    os.chdir(work)
    places = None
    laplace = env_extra.get("uq_method") == LAPLACE or (
        "--closed_loop" in extra and "laplace" in extra)
    real_uq, uq_calls = FullBatchedRolloutEngine._laplace_uq, []

    def record_uq(eng_, X, y, theta0, perts):
        trace, rmv = real_uq(eng_, X, y, theta0, perts)
        uq_calls.append((eng_, X, y, theta0, perts, trace, rmv))
        return trace, rmv
    try:
        FullBatchedRolloutEngine._laplace_uq = record_uq
        argv = _workdir(data_dir, stress, sims, **env_extra) + extra
        sdf, t_sdf = write_net_sdf(torch, argv, ckpt)
        sdf_occupied = float((sdf == 0).mean())
        sync = torch.cuda.synchronize

        draws = []
        real_generate = V.generate_path

        def generate(*ranges):
            draws.append(ranges)
            check(len(draws) <= 1 + MAX_RESTARTS, f"validate {argv[-1]}: "
                  f"more than {MAX_RESTARTS} 'Path not found' restarts")
            return real_generate(*ranges)
        V.generate_path = generate
        costs = {}

        def cost(key):
            def record(planner):
                with torch.no_grad():
                    costs[key] = float(planner.total_cost())
            return record
        def astar_said(planner):
            occ = getattr(planner, "occupied", None)
            print(f"validate: A* from {planner.start_state[:3].tolist()} to "
                  f"{planner.end_state[:3].tolist()}, 20^3 grid "
                  f"{'not built' if occ is None else float(occ.mean())} "
                  "occupied", flush=True)
        places = Places(sync, fused_mlp, [
            ("reset", NerfSimulator, "reset"),
            ("astar", Planner, "a_star_init"),
            ("learn_init", Planner, "learn_init"),
            ("observations", FullBatchedRolloutEngine, "_render_stats"),
            ("observations", FullBatchedRolloutEngine, "_render_laplace"),
            ("laplace map", FullBatchedRolloutEngine, "_laplace_map"),
            ("laplace lm", FullBatchedRolloutEngine, "_laplace_lm"),
            ("laplace", FullBatchedRolloutEngine, "_laplace_uq"),
            ("run", FullBatchedRolloutEngine, "monte_carlo"),
            ("run", FullBatchedRolloutEngine, "cem"),
            ("run", ClosedLoopBatchedEngine, "monte_carlo"),
            ("target", ClosedLoopBatchedEngine, "_target_pixels"),
            ("estimate", ClosedLoopBatchedEngine, "_estimate"),
            ("replan", ClosedLoopBatchedEngine, "_replan"),
            ("uq", FullBatchedRolloutEngine, "_gaussian_uq_moments")],
            hooks={"learn_init": (cost("first"), cost("last")),
                   "astar": (None, astar_said)})
        random.seed(0)
        fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
        fused_mlp.LAUNCHES_GROUPED = 0
        plain0 = fused_mlp.PLAIN_CALLS + fused_mlp.PLAIN_CALLS_GROUPED
        t0 = time.perf_counter()
        if "--closed_loop" in extra:
            horizon = closed_loop_horizon(CL_STEPS)
        elif env_extra.get("uq_method") == LAPLACE:
            horizon = open_loop_horizon(LAPLACE_MC_STEPS)
        else:
            horizon = contextlib.nullcontext()
        with horizon:
            res = V.main(argv, device="cuda")
        sync()
        t_all = time.perf_counter() - t0
        if keep is not None:
            shutil.copytree(work, keep)
        launches = fused_mlp.LAUNCHES
        grouped = fused_mlp.LAUNCHES_GROUPED
        plain = fused_mlp.PLAIN_CALLS + fused_mlp.PLAIN_CALLS_GROUPED \
            - plain0
        places.restore()
        FullBatchedRolloutEngine._laplace_uq = real_uq
        V.generate_path = real_generate

        sim = places.last["reset"]
        planner = sim.traj
        eng = places.last["run"]
        T = int(eng.steps)
        csvs = {f.name: list(csv.reader(open(f, newline="")))
                for f in Path("results").glob("collisionValues*.csv")}
        check(len(csvs) == 1 and all(csvs.values()),
              f"validate {extra}: no CSV with rows under results/")
        (csv_name, rows), = csvs.items()
        stats = dict(
            restarts=len(draws) - 1, sdf_s=t_sdf, sdf_occupied=sdf_occupied,
            astar_occupied=float(planner.occupied.mean()),
            knots=int(planner.states.shape[0]), steps=T, wall_s=t_all,
            learn_init_s=places.s["learn_init"],
            learn_init_cost=[costs.get("first"), costs.get("last")],
            k4={k: places.k4[k] for k in ("astar", "learn_init",
                                          "observations")},
            k4_all=launches, plain_calls=plain, run_s=places.s["run"],
            csv=csv_name, csv_rows=len(rows), k4_grouped=grouped)
        if laplace:
            stats.update(
                laplace_s={k: places.s[k] for k in ("observations",
                                                    "laplace map",
                                                    "laplace lm",
                                                    "laplace")},
                finite={k: float(np.isfinite(res[k]).mean())
                        for k in ("sigma_d", "reward", "trace")
                        if k in res},
                fits=laplace_finite_checks(torch, uq_calls,
                                           f"validate {extra}"))
            print(f"validate {' '.join(extra)} with the Laplace UQ: "
                  f"seconds in the observations, the MAP fits, the LM and "
                  f"the whole UQ {stats['laplace_s']}; grouped K4 "
                  f"launches {grouped}; finite shares {stats['finite']}; "
                  f"in-scan fits {stats['fits']}; {smi}", flush=True)
            check(stats["fits"]["fits"] > 0
                  and stats["fits"]["fits_finite"] >= LAPLACE_FINITE
                  and stats["finite"]["reward"] >= LAPLACE_FINITE,
                  f"validate {extra}: fewer than {LAPLACE_FINITE} of the "
                  f"in-scan Laplace fits or of the rewards are finite")
        ff = "--ff" in extra
        print(f"validate {' '.join(extra)} ({stress}, {sims} sims, "
              f"{VALIDATE_STEPS} samples a ray): {stats['restarts']} "
              f"restarts; SDF {sdf.shape} in {t_sdf:.2f} s, "
              f"{sdf_occupied:.4f} occupied; A* grid 20^3 "
              f"{stats['astar_occupied']:.4f} occupied, path of "
              f"{stats['knots']} cells, {T} steps; learn_init "
              f"{stats['learn_init_s']:.3f} s, cost {costs.get('first')} -> "
              f"{costs.get('last')}; K4 launches {stats['k4']} "
              f"(all {launches}), plain calls {plain}; wall {t_all:.2f} s; "
              f"{smi}")
        check(plain == 0, f"validate {extra}: K4's plain version was called")
        check(all(stats["k4"].values()) if ff else launches == 0,
              f"validate {extra}: K4 launches {stats['k4']} (all {launches})")
        check((grouped > 0) == (ff and laplace), f"validate {extra}: "
              f"grouped K4 launches {grouped}")
        check(costs["last"] < costs["first"], f"validate {extra}: "
              f"learn_init did not lower the cost {costs}")
        if isinstance(eng, ClosedLoopBatchedEngine):
            est, true = res["est_states"], res["true_states"]
            err = float(np.linalg.norm(est[..., :3] - true[..., :3],
                                       axis=-1).mean())
            n_steps = sims * T
            stats.update(
                s_per_sim_step=stats["run_s"] / n_steps,
                ms_per_step={k: 1e3 * places.s[k] / T for k in (
                    "target", "estimate", "replan", "observations", "uq")},
                est_pos_err_m=err, collision_rate=res["collision_rate"],
                sigma_d=[float(np.nanmin(res["sigma_d"])),
                         float(np.nanmax(res["sigma_d"]))])
            print(f"validate --closed_loop: {stats['run_s']:.2f} s for "
                  f"{sims} sims x {T} steps: {stats['s_per_sim_step']:.4f} "
                  f"s per sim-step; per population step (ms) "
                  f"{ {k: round(v, 2) for k, v in stats['ms_per_step'].items()} }"
                  f"; estimated position off the true one by {err:.5f} m "
                  f"on average; collision rate {res['collision_rate']}; "
                  f"sigma_d {stats['sigma_d']}; CSV {len(rows)} rows; {smi}")
            check(np.isfinite(est).all() and (laplace or np.isfinite(
                res["reward"]).all()), "validate --closed_loop: an estimate "
                "or a reward is not finite")
            return stats
        n_roll = sims if stress == "Monte Carlo" else max(sims, 10) * 5
        sig = res["sigma_d"] if "sigma_d" in res else None
        stats.update(rollouts_per_s=n_roll / stats["run_s"])
        if stress == "Monte Carlo":
            check(all(len(r) == 23 for r in rows), "validate MC CSV columns")
            # with the Laplace UQ a NaN reward (a fit from an overflowing
            # start) scales the sim's later disturbances: its likelihoods
            # and rewards stay NaN, and so do its fits unless it collided
            # (frozen state); the finite shares are held above
            ok = np.isfinite(sig)
            check(bool(laplace or (ok.all()
                                   and np.isfinite(res["reward"]).all()))
                  and bool((sig[ok] >= 0).all()),
                  "validate MC: sigma_d or the reward is not finite")
            stats.update(collision_rate=float(res["collided"].any(1).mean()),
                         sigma_d=[float(np.nanmin(sig)),
                                  float(np.nanmax(sig))])
            print(f"validate --ff MC: {n_roll} rollouts in "
                  f"{stats['run_s']:.3f} s, {stats['rollouts_per_s']:.3f} "
                  f"rollouts/s; collision rate {stats['collision_rate']}; "
                  f"sigma_d {stats['sigma_d']}; the CSV {len(rows)} rows; "
                  f"{smi}")
        else:
            n_rows, hits = cem_csv_rows_stop(rows, T)
            stats.update(history=res["history"], collided=hits)
            print(f"validate --ff CEM: {n_roll} rollouts in "
                  f"{stats['run_s']:.3f} s, {stats['rollouts_per_s']:.3f} "
                  f"rollouts/s; the 27-column CSV {n_rows} rows, {hits} "
                  f"sims' rows stopping at a collision; history "
                  f"{res['history']}; {smi}")
            check(bool(np.isfinite(res["means"]).all()),
                  "validate CEM: the proposal is not finite")
        # K4 on this path against its plain version (after the counts):
        # the planner's cost and its gradient in the knots at the learned
        # plan, and the start's observation
        stats.update(validate_k4_checks(torch, sim, planner, eng,
                                        planner_cost_terms))
        if laplace and ff:
            stats.update(laplace_k4_checks(torch, eng, smi))
        return stats
    finally:
        if places is not None:
            places.restore()
        FullBatchedRolloutEngine._laplace_uq = real_uq
        os.chdir(old)
        shutil.rmtree(work, ignore_errors=True)


def validate_k4_checks(torch, sim, planner, eng, planner_cost_terms):
    """K4 against its plain chain at the learned plan, with the cost's fade
    mask at 1: the planner's collision term [S+3] (the only term that
    reads the density) relative to its largest value, and its gradient in
    the knots relative to the largest component, at TOL_K4_COLLISION; the
    whole cost too (TOL_K4's sigma bound), which the 1000 fz^2 term
    dominates. A planted K4 error (PLANTED_K4_LOG_SIGMA added to the sigma
    net's first output, sigma 3% high) must fail the collision check.
    Then the start's observation through K4 and the plain field (the
    frames' image bounds, the UQ's inputs at TOL_UQ_STATS)."""
    from nerfsafetyvalidation_tpu_torch.models import network
    rot = torch.tensor(BLENDER_TO_NERF, device="cuda")
    net = sim.net

    def cost(plain):
        def density(x):
            return net.density(x.reshape(-1, 3) @ rot, plain=plain)[
                "sigma"].reshape(x.shape[:-1])
        knots = planner.states.detach().clone().requires_grad_(True)
        total, col = planner_cost_terms(
            knots, planner.initial_accel, planner.start_state,
            planner.end_state, max(planner.fade_out_epoch, 0),
            density_fn=density, dt=planner.dt, g_vec=planner.g, J=planner.J,
            mass=planner.mass, robot_body=planner.robot_body,
            fade_out_epoch=planner.fade_out_epoch,
            fade_out_sharpness=planner.fade_out_sharpness)
        g_tot, = torch.autograd.grad(total.mean(), knots, retain_graph=True)
        g_col, = torch.autograd.grad(col.sum(), knots)
        return total.detach(), g_tot, col.detach(), g_col

    def errs(k, p):
        (c_k, g_k, l_k, gl_k), (c_p, g_p, l_p, gl_p) = k, p
        return dict(
            cost=float(((c_k - c_p).abs() / c_p.abs().clamp(min=1.0)).max()),
            grad=float((g_k - g_p).abs().max()
                       / g_p.abs().max().clamp(min=1e-30)),
            col=float((l_k - l_p).abs().max()
                      / l_p.abs().max().clamp(min=1e-30)),
            col_grad=float((gl_k - gl_p).abs().max()
                           / gl_p.abs().max().clamp(min=1e-30)))
    p = cost(True)
    e = errs(cost(False), p)
    real_k4 = network.fused_mlp

    def planted(h, weights, dtype):
        out = real_k4(h, weights, dtype)
        return torch.cat([out[:, :1] + PLANTED_K4_LOG_SIGMA, out[:, 1:]], 1)
    network.fused_mlp = planted
    try:
        e_planted = errs(cost(False), p)
    finally:
        network.fused_mlp = real_k4
    with torch.inference_mode():
        o, d = eng._obs_rays(eng._pose_from_state(eng.start_state[None]))
        call = eng._obs_call()
        k_out, p_out = call(o, d), call(o, d, plain_field=True)
        img = (k_out["image"] - p_out["image"]).abs()
        st_k, st_p = eng._obs_stats(k_out)[0], eng._obs_stats(p_out)[0]
        st_err = float(((st_k - st_p).abs() / st_p.abs().clamp(
            min=1e-30)).max())
    tol, tol_col = TOL_K4["sigma"][0], TOL_K4_COLLISION
    print(f"validate K4 vs plain: planner cost [{p[0].shape[0]}] max rel "
          f"{e['cost']:.3e} (cost up to {float(p[0].max()):.4g}), its "
          f"gradient in the knots max {e['grad']:.3e} of its largest "
          f"{float(p[1].abs().max()):.4g}; the collision term max "
          f"{e['col']:.3e} of its largest {float(p[2].abs().max()):.4g}, "
          f"its gradient max {e['col_grad']:.3e} of its largest "
          f"{float(p[3].abs().max()):.4g}; with a planted K4 error of "
          f"{PLANTED_K4_LOG_SIGMA} on log sigma: cost {e_planted['cost']:.3e}"
          f", gradient {e_planted['grad']:.3e}, collision term "
          f"{e_planted['col']:.3e}, its gradient {e_planted['col_grad']:.3e}"
          f"; the start's observation image max {float(img.max()):.3e} mean "
          f"{float(img.mean()):.3e}, UQ inputs max rel {st_err:.3e}")
    check(e["cost"] <= tol and e["grad"] <= tol, "validate: the planner's "
          f"cost or gradient through K4 is off the plain chain's by more "
          f"than {tol}")
    check(e["col"] <= tol_col and e["col_grad"] <= tol_col, "validate: the "
          "planner's collision term or its gradient through K4 is off the "
          f"plain chain's by more than {tol_col}")
    check(e_planted["col"] > tol_col or e_planted["col_grad"] > tol_col,
          "validate: the collision check does not see a planted K4 error")
    check(float(img.max()) <= TOL_IMG_MAX and float(img.mean())
          <= TOL_IMG_MEAN and st_err <= TOL_UQ_STATS,
          "validate: the observation through K4 is off the plain field's")
    return dict(k4_cost_rel=e["cost"], k4_grad_rel=e["grad"],
                k4_collision_rel=e["col"], k4_collision_grad_rel=e["col_grad"],
                planted=e_planted, obs_img_max=float(img.max()),
                obs_stats_rel=st_err)


def astar_occupied(torch, net):
    """The share of A*'s 20^3 grid that the planner marks occupied for a
    net, through the validate CLI's density closure (Planner.a_star_init's
    100^3 probe, max-pooled, above 0.3)."""
    lin = np.linspace(-1, 1, 100, dtype=np.float32)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    rot = torch.tensor(BLENDER_TO_NERF, device="cuda")
    with torch.inference_mode():
        sig = net.density(torch.from_numpy(pts.reshape(-1, 3)).cuda()
                          @ rot)["sigma"].float().cpu().numpy()
    return float((sig.reshape(20, 5, 20, 5, 20, 5).max(axis=(1, 3, 5))
                  > 0.3).mean())


def validate_refusal(V, data_dir, extra, msg, batched=True):
    """The CLI refuses `extra` with `msg` within seconds, before loading
    (with --batched_rollouts, or on the sequential path)."""
    old, work = os.getcwd(), tempfile.mkdtemp()
    os.chdir(work)
    try:
        argv = [a for a in _workdir(data_dir, "Monte Carlo", 16)
                if batched or a != "--batched_rollouts"] + extra
        t0 = time.perf_counter()
        why = None
        try:
            V.main(argv, device="cuda")
        except SystemExit as e:
            why = str(e)
        dt = time.perf_counter() - t0
        print(f"validate {' '.join(extra)}: refused in {dt:.3f} s: {why}")
        check(why is not None and msg in why and dt < 10.0
              and os.listdir(".") == ["envConfig.json"],
              f"validate {extra} was not refused at once")
    finally:
        os.chdir(old)
        shutil.rmtree(work, ignore_errors=True)


# The sequential phases: the port's validate CLI without --batched_rollouts
# (envConfig.json as shipped: NerfSimulator, Monte Carlo, the Gaussian UQ,
# the 800^2 camera, the estimator's batch of 1024 pixels and 100 Adam
# steps, the planner's 1000 + 250 epochs), its CrossEntropyMethod on the
# same simulator, and the simulate entry point, on VALIDATE_UNFUSED's net
# (the CLI's default float32 NeRFNetwork: no kernel on this path in either
# package) with --camera nerf. Cut: the population (SEQ_SIMS sims; CEM
# m = 2, m_elite = 1, kmax = 1), the samples a ray (VALIDATE_STEPS) and the
# depth: each sim's first SEQ_STEPS steps of the planned flight (the Monte
# Carlo test's horizon, the CEM's trajectories), which keeps the smoke
# inside its time limit on a slower host; at least 2, so that a step flies
# on the previous step's estimate and replan.
SEQ_SIMS = 1
SEQ_CEM = dict(m=2, m_elite=1, kmax=1)
SEQ_STEPS = 2
# simulate (phase 24) thins A*'s knots to SIM_KNOTS, evenly spaced from
# start to goal, before learn_init: a plan of SIM_KNOTS + 3 actions, so it
# flies 7 steps in place of the whole path's (11 on the MC phase's path):
# the first 2 with their estimate and replan, the last 5 on the plan
# (simulate's tail branch, no replan), each on the step before's estimate;
# cut to make room for phase 34 on a slower host
SIM_KNOTS = 4
# measurement_fn at the last fit's optimum, its value and its gradient in
# the state, on the card and on the CPU from the same inputs (the net's
# weights copied to the CPU). float32 on both, other summation orders
# (cuBLAS and the CPU's, the mean over 1,024 pixels, the compositing): the
# value ~1e-6 relative; bound 1e-4. The gradient: as above per sample, but
# a sample whose position lies within a last-bit difference of a hash
# cell's face (the rays' directions come from an einsum, summed in other
# orders) takes the neighbouring cell's slope on one side only; stated
# before the first run: bound 1e-2 of the gradient's largest component.
TOL_MEAS = dict(loss=1e-4, grad=1e-2)
# the per-step seconds the phases print, by place (see sequential_places)
SEQ_PARTS = ("camera", "observation", "uq render", "uq fit", "fit",
             "hessian", "replan", "sdf")


def sequential_places(torch, fused_mlp):
    """Places over the sequential step's parts: the agent's capture (the
    NeRF camera), the observation render, the UQ's render and its fit (the
    sums and scipy), the estimator's Adam fit, its Hessian (with the rest
    of estimate_state under 'estimate'), the replan, the SDF check, and
    the step and reset as wholes."""
    from nerfsafetyvalidation_tpu_torch.nav import estimator as E
    from nerfsafetyvalidation_tpu_torch.nav.agent import Agent
    from nerfsafetyvalidation_tpu_torch.nav.planner import Planner
    from nerfsafetyvalidation_tpu_torch.uq.gaussian_approximation import (
        GaussianApproximationDensityUncertainty as GA)
    from nerfsafetyvalidation_tpu_torch.validation.simulators import (
        NerfSimulator)
    return Places(torch.cuda.synchronize, fused_mlp, [
        ("reset", NerfSimulator, "reset"),
        ("astar", Planner, "a_star_init"),
        ("learn_init", Planner, "learn_init"),
        ("step", NerfSimulator, "step"),
        ("camera", Agent, "step"),
        ("observation", E.Estimator, "render_from_pose"),
        ("uq render", E.Estimator, "render_for_uncertainty"),
        ("uq fit", GA, "__init__"), ("uq fit", GA, "optimize"),
        ("estimate", E.Estimator, "estimate_state"),
        ("fit", E.Estimator, "fit"),
        ("hessian", E, "hessian_rows"),
        ("replan", Planner, "learn_update"),
        ("sdf", NerfSimulator, "_sdf_check")])


class FitWatch:
    """Wraps Estimator.measurement_fn: every call's state, start state,
    covariance, target and batch must lie on the card (the tensors of the
    fit and of the Hessian), and after each estimate_state the estimate and
    its covariance must be finite; records each step's distance between the
    estimated and the true position."""

    def __init__(self, E):
        self.E, self.orig = E, E.Estimator.measurement_fn
        self.off_card, self.calls, self.err, self.bad = [], 0, [], []
        watch = self

        def measurement_fn(est, state, start_state, sig, target, batch):
            watch.calls += 1
            for name, t in (("state", state), ("start_state", start_state),
                            ("sig", sig), ("target", target),
                            ("batch", batch)):
                if t.device.type != "cuda":
                    watch.off_card.append((name, str(t.device)))
            return watch.orig(est, state, start_state, sig, target, batch)
        E.Estimator.measurement_fn = measurement_fn

    def after_estimate(self, est):
        xt, sig = est.xt, est.sig
        true = est.agent.x
        self.err.append(float((xt[:3] - true[:3]).norm()))
        if not (bool(xt.isfinite().all()) and bool(sig.isfinite().all())):
            self.bad.append(est.iteration)

    def restore(self):
        if self.E is not None:
            self.E.Estimator.measurement_fn = self.orig
            self.E = None


def measurement_card_vs_cpu(torch, est, sim, opt):
    """measurement_fn's value and gradient 0.01 off the estimator's last
    estimate in every coordinate (its target, batch, estimate and
    covariance) on the card, and on the CPU with the net's weights copied
    there: TOL_MEAS."""
    import copy
    from nerfsafetyvalidation_tpu_torch.data.rays import get_rays
    from nerfsafetyvalidation_tpu_torch.models import make_network
    from nerfsafetyvalidation_tpu_torch.models import renderer as R
    net = sim.net
    net_cpu = make_network(net.cfg, {k: ([w.cpu() for w in v]
                                         if isinstance(v, list) else
                                         {kk: vv.cpu() for kk, vv in
                                          v.items()})
                                     for k, v in net.params_tree().items()},
                           device="cpu")
    H, W = est.target.shape[:2]
    intr = sim.dataset_intrinsics

    def value_grad(e, dev):
        # 0.01 off the optimum, so that the prior's gradient is not 0
        leaf = (est.xt.detach() + 0.01).to(dev).requires_grad_(True)
        loss = e.measurement_fn(leaf, est.xt.to(dev), est.sig.to(dev),
                                est.target.to(dev), est.batch.to(dev))
        g, = torch.autograd.grad(loss, leaf)
        return float(loss.detach()), g.cpu()
    card = value_grad(est, "cuda")
    cpu_est = copy.copy(est)
    cpu_est.device = torch.device("cpu")
    cpu_est.get_rays = lambda pose: get_rays(pose, intr, H, W, device="cpu")
    cpu_est.render_batch_fn = lambda o, d: R.render(
        net_cpu, o, d, staged=False, bg_color=1.0, num_steps=opt.num_steps,
        upsample_steps=opt.upsample_steps)
    cpu = value_grad(cpu_est, "cpu")
    loss_rel = abs(card[0] - cpu[0]) / max(abs(cpu[0]), 1e-30)
    grad_rel = float((card[1] - cpu[1]).abs().max()
                     / cpu[1].abs().max().clamp(min=1e-30))
    return dict(loss_card=card[0], loss_cpu=cpu[0], loss_rel=loss_rel,
                grad_rel=grad_rel, grad_max=float(cpu[1].abs().max()))


def _seq_times(places, n_steps):
    per = {k: places.s[k] / max(n_steps, 1) for k in SEQ_PARTS}
    per["estimate other"] = (places.s["estimate"] - places.s["fit"]
                             - places.s["hessian"]) / max(n_steps, 1)
    per["step"] = places.s["step"] / max(n_steps, 1)
    return per


@contextlib.contextmanager
def mc_horizon(V, steps):
    """validate's sequential MonteCarlo cut to each sim's first `steps`
    steps (the smoke's depth cut of the sequential phases)."""
    real = V.MonteCarlo
    V.MonteCarlo = lambda sim, n, s, *a, **k: real(sim, n, min(s, steps),
                                                   *a, **k)
    try:
        yield
    finally:
        V.MonteCarlo = real


def sequential_phase(torch, V, data_dir, ckpt, smi, keep=None):
    """(a) validate's default sequential Monte Carlo and (b) the port's
    CrossEntropyMethod on the same simulator, in one temporary working
    directory (envConfig.json with n_simulations SEQ_SIMS, the SDF of the
    net, its checkpoint). With `keep`, the working directory (its CSVs,
    path and pose cache) is copied there at the end, for the
    --fast_render and replay phases. Returns their numbers."""
    import random
    from nerfsafetyvalidation_tpu_torch.nav import estimator as E
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    from nerfsafetyvalidation_tpu_torch.validation.distributions import (
        SeedableMultivariateNormal)
    from nerfsafetyvalidation_tpu_torch.validation.stresstests import (
        CrossEntropyMethod)
    old, work = os.getcwd(), tempfile.mkdtemp()
    os.chdir(work)
    places = watch = None
    stats = {}
    real_generate = V.generate_path
    try:
        env = json.loads((ROOT / "envConfig.json").read_text())
        env["n_simulations"] = SEQ_SIMS
        Path("envConfig.json").write_text(json.dumps(env))
        argv = [data_dir, "--workspace", "ws", "--bound", "1", "--scale",
                "1", "--seed", "0", "--num_steps", str(VALIDATE_STEPS),
                "--camera", "nerf"]
        sdf, t_sdf = write_net_sdf(torch, argv, ckpt)
        draws = []

        def generate(*ranges):
            draws.append(ranges)
            check(len(draws) <= 1 + MAX_RESTARTS, "sequential validate: "
                  f"more than {MAX_RESTARTS} 'Path not found' restarts")
            return real_generate(*ranges)
        V.generate_path = generate
        watch = FitWatch(E)
        places = sequential_places(torch, fused_mlp)
        places.hooks["estimate"] = (None, watch.after_estimate)
        random.seed(0)
        fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
        with Phase("sequential MC"), mc_horizon(V, SEQ_STEPS):
            t0 = time.perf_counter()
            V.main(argv, device="cuda")
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
            rows = list(csv.reader(open(
                f"results/collisionValuesBlenderMC_n{SEQ_SIMS}.csv",
                newline="")))
            n_steps = len(watch.err)
            steps = min(SEQ_STEPS, json.loads(Path(
                "results/coordinates.json").read_text())["steps"])
            sim = places.last["reset"]
            check("fit" in places.last, "sequential MC: the estimator never "
                  "fitted (no interest points in any observation)")
            est = places.last["fit"]
            check(len(rows) == n_steps > 0 and all(len(r) == 24
                                                   for r in rows),
                  "sequential MC: the CSV's rows are not one a step of 24 "
                  "columns")
            check(all(np.isfinite(float(v)) for r in rows
                      for v in r[2:22]), "sequential MC: a CSV number is "
                  "not finite")
            reward = [float(r[20]) for r in rows]
            sigma_d = [float(r[21]) for r in rows]
            hits = sum(r[-2] == "True" for r in rows)
            check(not watch.off_card, "sequential MC: a tensor of the fit "
                  f"is not on cuda: {watch.off_card[:5]}")
            watch.restore()     # the CPU comparison below is off the card
            meas = measurement_card_vs_cpu(
                torch, est, sim, V.apply_O_flag(
                    V.build_parser("validate").parse_args(argv), "validate"))
            per = _seq_times(places, n_steps)
            start, end, _ = V.load_coords()
            stats["MC"] = dict(path=[start, end],
                wall_s=t_all, restarts=len(draws) - 1, steps=steps,
                sim_steps=n_steps, sdf_s=t_sdf,
                sdf_occupied=float((sdf == 0).mean()),
                astar_occupied=float(sim.traj.occupied.mean()),
                reset_s=places.s["reset"], learn_init_s=places.s[
                    "learn_init"], s_per_sim_step=per,
                est_err_m=list(watch.err), collisions=hits,
                csv_rows=len(rows), detector=E.detector(),
                sigma_d=[min(sigma_d), max(sigma_d)],
                reward=[min(reward), max(reward)],
                measurement=meas, fit_calls=watch.calls,
                k4=fused_mlp.LAUNCHES + fused_mlp.LAUNCHES_F32)
            _print_seq("sequential MC", stats["MC"], smi)
            check(not watch.bad, f"sequential MC: a state or covariance is "
                  f"not finite (steps {watch.bad})")
            check(meas["loss_rel"] <= TOL_MEAS["loss"]
                  and meas["grad_rel"] <= TOL_MEAS["grad"],
                  f"sequential MC: measurement_fn on the card differs from "
                  f"the CPU's beyond {TOL_MEAS}: {meas}")
            check(stats["MC"]["k4"] == 0, "sequential MC launched K4 on "
                  "the CLI's unfused float32 net")

        with Phase("sequential CEM"):
            for k in places.s:
                places.s[k] = 0.0
            watch = FitWatch(E)
            places.hooks["estimate"] = (None, watch.after_estimate)
            mean = np.asarray(env["mpc_cfg"]["mpc_noise_mean"], np.float32)
            cov = np.diag(np.asarray(env["mpc_cfg"]["mpc_noise_std"],
                                     np.float32) ** 2)
            q = SeedableMultivariateNormal([mean] * steps, [cov] * steps,
                                           noise_seed=0, device="cuda")
            p = SeedableMultivariateNormal([mean] * steps, [cov] * steps,
                                           noise_seed=0, device="cuda")
            cem = CrossEntropyMethod(sim, q, p, noise_seed=0,
                                     blend_file=None, workspace="ws",
                                     **SEQ_CEM)
            t0 = time.perf_counter()
            res = cem.optimize()
            torch.cuda.synchronize()
            t_cem = time.perf_counter() - t0
            rows = list(csv.reader(open(
                "results/collisionValuesCEM_m{m}melite{m_elite}k{kmax}.csv"
                .format(**SEQ_CEM), newline="")))
            n_rows, cem_hits = cem_csv_rows_stop(rows, steps)
            n_cem = len(watch.err)
            reward = [float(r[15]) for r in rows]
            sigma_d = [float(r[16]) for r in rows]
            stats["CEM"] = dict(
                wall_s=t_cem, sim_steps=n_cem, csv_rows=n_rows,
                collisions=cem_hits, s_per_sim_step=_seq_times(places,
                                                               n_cem),
                est_err_m=list(watch.err), detector=E.detector(),
                sigma_d=[min(sigma_d), max(sigma_d)],
                reward=[min(reward), max(reward)],
                best_value=float(res[5]),
                k4=fused_mlp.LAUNCHES + fused_mlp.LAUNCHES_F32)
            _print_seq("sequential CEM", stats["CEM"], smi)
            check(not watch.bad, "sequential CEM: a state or covariance is "
                  "not finite")
            check(not watch.off_card, "sequential CEM: a tensor of the fit "
                  "is not on cuda")
            check(all(np.isfinite(np.asarray(m)).all() for m in res[0])
                  and np.isfinite(res[5]), "sequential CEM: the proposal "
                  "or the best value is not finite")
            check(stats["CEM"]["k4"] == 0, "sequential CEM launched K4")
        if keep is not None:
            shutil.copytree(work, keep)
        return stats
    finally:
        if places is not None:
            places.restore()
        if watch is not None:
            watch.restore()
        V.generate_path = real_generate
        os.chdir(old)
        shutil.rmtree(work, ignore_errors=True)


def _print_seq(name, st, smi):
    per = {k: round(v, 4) for k, v in st["s_per_sim_step"].items()}
    errs = [round(e, 4) for e in st["est_err_m"]]
    print(f"{name}: {st['sim_steps']} sim-steps in {st['wall_s']:.2f} s; "
          f"seconds per sim-step {per}; the estimate off the true position "
          f"(m) at each step {errs}; CSV {st['csv_rows']} rows, "
          f"{st['collisions']} collisions; detector {st['detector']}; "
          f"sigma_d {st['sigma_d']}; reward {st['reward']}; K4 launches "
          f"{st['k4']}; {smi}", flush=True)
    if "measurement" in st:
        m = st["measurement"]
        print(f"{name}: measurement_fn card vs CPU at the last fit: loss "
              f"{m['loss_card']:.8g} vs {m['loss_cpu']:.8g} (rel "
              f"{m['loss_rel']:.3e}, bound {TOL_MEAS['loss']}), gradient "
              f"max {m['grad_rel']:.3e} of its largest {m['grad_max']:.4g} "
              f"(bound {TOL_MEAS['grad']})", flush=True)


def simulate_phase(torch, data_dir, ckpt, fallback_path, smi):
    """(c) `simulate` as a user runs it (envConfig.json as shipped, the
    net's checkpoint, --camera nerf, VALIDATE_STEPS samples a ray). When
    A* finds no path between envConfig's start and goal in this net, the
    phase says so and flies the MC phase's path (fallback_path: start,
    goal) instead. Returns its numbers."""
    from nerfsafetyvalidation_tpu_torch import simulate as S
    from nerfsafetyvalidation_tpu_torch.nav import estimator as E
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    old, work = os.getcwd(), tempfile.mkdtemp()
    os.chdir(work)
    places = watch = None
    try:
        env = json.loads((ROOT / "envConfig.json").read_text())
        Path("envConfig.json").write_text(json.dumps(env))
        argv = [data_dir, "--workspace", "ws", "--bound", "1", "--scale",
                "1", "--seed", "0", "--num_steps", str(VALIDATE_STEPS),
                "--camera", "nerf"]
        load_cli_net(torch, argv, ckpt, entry="simulate")
        watch = FitWatch(E)
        places = sequential_places(torch, fused_mlp)
        places.hooks["estimate"] = (None, watch.after_estimate)
        replans, knots = [], []

        def thin(planner):
            # A*'s knots, SIM_KNOTS of them kept (first and last included)
            n_astar = planner.states.shape[0]
            keep = np.unique(np.linspace(0, n_astar - 1, SIM_KNOTS).round()
                             .astype(np.int64))
            planner.states = planner.states[torch.as_tensor(
                keep, device=planner.states.device)]
            knots[:] = [n_astar, planner.states.shape[0]]

        places.hooks["astar"] = (None, thin)
        places.hooks["replan"] = (None, replans.append)
        fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
        path = "envConfig's"
        t0 = time.perf_counter()
        try:
            states = S.main(argv, device="cuda")
        except (ValueError, AssertionError) as e:
            print(f"simulate: A* finds no path from envConfig's start to its "
                  f"goal in this net ({type(e).__name__}: {e}); flying the "
                  f"sequential MC phase's path {fallback_path}", flush=True)
            env["planner_cfg"].update(start_pos=list(fallback_path[0]),
                                      end_pos=list(fallback_path[1]))
            Path("envConfig.json").write_text(json.dumps(env))
            path = "the MC phase's"
            for k in places.s:
                places.s[k] = 0.0
            watch.err.clear()
            replans.clear()
            t0 = time.perf_counter()
            states = S.main(argv, device="cuda")
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        n = states.shape[0] - 1
        per = _seq_times(places, n)
        st = dict(wall_s=t_all, path=path, sim_steps=n,
                  learn_init_s=places.s["learn_init"],
                  s_per_sim_step=dict({k: per[k] for k in (
                      "camera", "fit", "hessian", "estimate other",
                      "replan")}, step=t_all / max(n, 1)),
                  est_err_m=list(watch.err), detector=E.detector(),
                  replans=len(os.listdir("paths/ws/replan_poses")),
                  k4=fused_mlp.LAUNCHES + fused_mlp.LAUNCHES_F32)
        per = {k: round(v, 4) for k, v in st["s_per_sim_step"].items()}
        print(f"simulate ({path} path): A* knots {knots[0]} thinned to "
              f"{knots[1]}; {n} steps ({len(replans)} with a replan) in "
              f"{t_all:.2f} s "
              f"(learn_init {st['learn_init_s']:.2f} s); seconds per step "
              f"{per}; the estimate off the true position (m) at each "
              f"step {[round(e, 4) for e in st['est_err_m']]}; replan "
              f"files {st['replans']}; detector {st['detector']}; K4 "
              f"launches {st['k4']}; {smi}", flush=True)
        check(np.isfinite(states).all() and not watch.bad,
              "simulate: a state or covariance is not finite")
        check(not watch.off_card, "simulate: a tensor of the fit is not on "
              "cuda")
        check(len(watch.err) == n, "simulate: not one estimate a step")
        check(n == knots[1] + 3 and len(replans) == n - 5 > 0,
              f"simulate flew {n} steps, {len(replans)} with a replan, not "
              f"{knots[1] + 3} with the last 5 on the plan")
        check(st["k4"] == 0, "simulate launched K4")
        return st
    finally:
        if places is not None:
            places.restore()
        if watch is not None:
            watch.restore()
        os.chdir(old)
        shutil.rmtree(work, ignore_errors=True)


# ---- the Bayesian-Laplace UQ (phases 25-28) --------------------------------
LAPLACE = "Bayesian Laplace Approximation"
GAUSSIAN = "Gaussian Approximation"
# kernel K4's grouped mode (the in-scan Laplace fits: one sigma net a sim)
# at the batched engine's shape (16 sims x the fits' 256 points) on the FF
# sigma net, at a ragged one, and on a narrow net of odd widths: (G, N,
# widths, weights as strided views of flat vectors as the fits pass them,
# or contiguous [G, in, out])
FF_SIGMA = [32, 64, 64, 16]
K4G_SHAPES = ((16, 256, FF_SIGMA, "views"), (5, 200, FF_SIGMA, "views"),
              (3, 40, [24, 48, 8], "contiguous"))
# The fits' -log posterior through K4 against the plain chain at the same
# theta and points, relative, and its gradient in theta, of its largest
# component. Stated before the first run on the card: the loss sums
# 640,000 (uncertain) or 256 (validate) squared residuals of sigma =
# exp(s0), s0 off by TOL_K4's sigma-net mean (1e-6 of max(|s0|, 1)) and now
# and then by a bf16 step: bound 1e-4; the gradient: K4's bf16 gradient
# bound, 1e-2 of the largest (tests/test_torch_k4_grad.py).
TOL_LAPLACE = dict(loss=1e-4, grad=1e-2)
# The start's in-scan LM (20 steps) from the same MAP theta through the
# kernel and through the plain chain, lmbda and the stops held equal: the
# iterate x and g's worst entry relative to their largest, g's norm
# relative. Stated before the first run: K4's bf16 gradient bound (1e-2 of
# the largest) for x and g's norm; g's worst entry 5e-2, as an LM step
# that overshoots magnifies rounding (tests/test_torch_laplace_engine.py
# measured 0.12 between two implementations on the CPU).
TOL_LAPLACE_LM = dict(x=1e-2, g_norm=1e-2, g=5e-2)
# the least finite share of the in-scan fits (trace and rmv) and of the
# rewards in phases 27-28 (the last chip run: 99.4% and 97.2%), and of the
# sequential MC's rmv; every view of `uncertain` must be finite
LAPLACE_FINITE = 0.9
# the phases' sims: validate --ff MC (phase 19's 16), the closed loop's 4,
# the sequential MC's 1 (64 samples a ray everywhere, VALIDATE_STEPS)
LAPLACE_SIMS = dict(mc=16, closed_loop=4, sequential=1)
# uncertain's samples a ray (the smoke's 64, VALIDATE_STEPS' count)
UNCERTAIN_STEPS = 64
# the views `uncertain` renders and fits, each a full 800^2 frame and the
# MAP fits on its 640,000 points (the depth cut that keeps the smoke
# inside its time limit on a slower host)
UNCERTAIN_VIEWS = 1
# the sequential Laplace phase's restarts of validate's loop at most (a NaN
# state would restart it for ever, see laplace_sequential_phase)
LAPLACE_RESTARTS = 2


class PhaseStop(Exception):
    """Ends a phase's CLI run from inside it (not a ValueError or an
    AssertionError, which validate's restart loop catches)."""


def k4_grouped_phase(torch, fused_mlp, smi):
    """Phase 25: the grouped kernel against its plain version (the
    vmapped chain as batched products) at K4G_SHAPES, weights and x from a
    seeded generator; each group against the single mode's kernel on its
    own weights (bit for bit); 20 reruns bit-identical; one CUDA kernel a
    call (the profiler's count); at the first shape the gradients in the
    weights the recompute's, bit for bit, and kernel, plain, library (one
    bf16 torch.bmm chain) and bound times."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    for G, N, widths, kind in K4G_SHAPES:
        x = torch.randn((G, N, widths[0]), generator=gen,
                        device=dev).to(torch.bfloat16)
        # as the fits pass them: [G, in, out] views of one flat [G, n]
        # vector, each layer [out, in] in it (set_sigma_net_flat)
        theta = torch.cat([(torch.randn((G, b, a), generator=gen, device=dev)
                            / a ** 0.5).reshape(G, -1)
                           for a, b in zip(widths, widths[1:])], dim=1)
        ws, start = [], 0
        for a, b in zip(widths, widths[1:]):
            ws.append(theta[:, start:start + a * b].reshape(G, b, a)
                      .transpose(-1, -2))
            start += a * b
        if kind == "contiguous":
            ws = [w.contiguous() for w in ws]

        def k4g(x=x, ws=ws):
            return (fused_mlp.fused_mlp_grouped(x, ws),)

        def plain(x=x, ws=ws):
            return (fused_mlp.fused_mlp_grouped_plain(x, ws),)
        n0 = fused_mlp.LAUNCHES_GROUPED
        got, = k4g()
        torch.cuda.synchronize()
        check(fused_mlp.LAUNCHES_GROUPED == n0 + 1,
              "the grouped K4 did not launch once")
        want, = plain()
        check(got.shape == (G, N, widths[-1])
              and bool(torch.isfinite(got).all()),
              f"K4 grouped output is not finite [{G}, {N}, {widths[-1]}]")
        rel = (got - want).abs() / want.abs().clamp(min=1.0)
        single = torch.stack([fused_mlp.fused_mlp(x[g].contiguous(),
                                                  [w[g] for w in ws])
                              for g in range(G)])
        same = reruns_equal(torch, k4g, (got,))
        err = float((got - want).abs().max())
        names = kernels_in(torch, k4g)
        print(f"K4 grouped G {G} x N {N}, {widths}, {kind} weights: vs "
              f"plain max rel "
              f"{float(rel.max()):.3e} mean {float(rel.mean()):.3e} (max "
              f"abs {err:.3e}); each group bit-equal to the single mode: "
              f"{bool(torch.equal(single, got))}; {same} of {RERUNS} reruns "
              f"bit-identical; CUDA kernels in one call: {names}")
        t_max, t_mean = TOL_K4["sigma"]
        check(float(rel.max()) <= t_max and float(rel.mean()) <= t_mean,
              f"K4 grouped disagrees with its plain version (tolerance "
              f"max {t_max}, mean {t_mean})")
        check(torch.equal(single, got), "K4 grouped differs from the "
              "single mode on a group's own weights")
        check(same == RERUNS, "K4 grouped gives other values on a rerun")
        # one call is one CUDA kernel: each block packs its group's image
        check(len(names) == 1, f"K4 grouped ran {len(names)} CUDA kernels "
              f"in one call, not one: {names}")
        rec[(G, N)] = dict(x=x, ws=ws, k4g=k4g, plain=plain, err=err)

    G, N = K4G_SHAPES[0][:2]
    r = rec[(G, N)]
    c = torch.randn((G, N, FF_SIGMA[-1]), generator=gen, device=dev)
    lk = [w.clone().requires_grad_(True) for w in r["ws"]]
    lr = [w.clone().requires_grad_(True) for w in r["ws"]]
    g_k = torch.autograd.grad(
        (fused_mlp.fused_mlp_grouped(r["x"], lk) * c).sum(), lk)
    g_r = torch.autograd.grad(
        (fused_mlp.fused_mlp_reference(r["x"], lr) * c).sum(), lr)
    same_grad = all(torch.equal(a, b) for a, b in zip(g_k, g_r))
    print(f"K4 grouped gradients in the weights: the recompute's bit for "
          f"bit: {same_grad}")
    check(same_grad, "K4 grouped's weight gradients are not the "
          "recompute's")
    wb = [w.to(torch.bfloat16) for w in r["ws"]]

    def library():
        h = r["x"]
        for i, w in enumerate(wb):
            h = torch.bmm(h, w)
            if i != len(wb) - 1:
                h = torch.relu(h)
        return h
    macs = sum(a * b for a, b in zip(FF_SIGMA, FF_SIGMA[1:]))
    # the inputs as the call takes them: x in bf16, each group's f32
    # weights (read once; the kernel rounds them in shared memory)
    bound, by = bound_ms(2.0 * G * N * macs,
                         G * N * (FF_SIGMA[0] * 2 + FF_SIGMA[-1] * 4)
                         + G * 4 * macs)
    ms = cuda_ms(torch, r["k4g"], 50)
    plain_ms = cuda_ms(torch, r["plain"], 20)
    lib_ms = cuda_ms(torch, library, 50)
    print(f"K4 grouped at G {G} x N {N} ({2 * macs} FLOP a row, "
          f"{4 * macs} bytes of f32 weights a group): kernel_ms {ms:.5f} "
          f"(one launch a call, blocks packing their own images), plain_ms "
          f"{plain_ms:.5f}, library_ms {lib_ms:.5f} (bf16 torch.bmm chain), "
          f"bound_ms {bound:.6f} ({by}); {smi}")
    return dict(err=max(v["err"] for v in rec.values()), ms=ms,
                plain_ms=plain_ms, lib_ms=lib_ms, bound=bound, by=by)


def kernels_in(torch, fn):
    """The names of the CUDA kernels that one call of fn() runs, by the
    profiler (CUPTI)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@contextlib.contextmanager
def plain_k4(fused_mlp):
    """K4's single and grouped modes swapped for their plain versions
    where the nets call them (models/network.py's names), to compare the
    kernel's results with the plain chain's on the same tensors."""
    from nerfsafetyvalidation_tpu_torch.models import network as N
    saved = N.fused_mlp, N.fused_mlp_grouped
    N.fused_mlp = fused_mlp.fused_mlp_plain
    N.fused_mlp_grouped = fused_mlp.fused_mlp_grouped_plain
    try:
        yield
    finally:
        N.fused_mlp, N.fused_mlp_grouped = saved


def _nlp_and_grad(torch, bl, theta, plain):
    """The fit's -log posterior at theta on its points (their encoding) and
    its gradient, the sigma net through K4 or its plain version."""
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    from nerfsafetyvalidation_tpu_torch.uq.bayesian_laplace import (
        nlp_and_grad)
    with plain_k4(fused_mlp) if plain else contextlib.nullcontext():
        loss, g = nlp_and_grad(bl.net, theta, bl._h, bl.y, bl.prior_mean,
                               bl.prior_std)
    return float(loss), g


def uncertain_phase(torch, data_dir, ckpt, method, smi):
    """Phase 26: `uncertain -O --ff` as a user runs it, in a temporary
    working directory (envConfig.json with `method`, the checkpoint of the
    main_nerf -O --ff run), on a spheres directory of UNCERTAIN_VIEWS
    training views and an 800^2 test view (the rays' size),
    UNCERTAIN_STEPS samples a ray:
    each view's staged render and, with the Laplace UQ, its MAP fits on
    all 640,000 points, LM and inverse; K4 launched in the render and at
    least once an Adam step, its plain versions never; the fit's -log
    posterior and gradient through K4 against the plain chain; trace,
    rmv, the heat map; seconds by part. Returns its numbers."""
    from nerfsafetyvalidation_tpu_torch import uncertain as U
    from nerfsafetyvalidation_tpu_torch.models import renderer as R
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    from nerfsafetyvalidation_tpu_torch.uq import hessian as TH
    from nerfsafetyvalidation_tpu_torch.uq.bayesian_laplace import (
        BayesianLaplace)
    old, work = os.getcwd(), tempfile.mkdtemp()
    os.chdir(work)
    places = None
    try:
        env = json.loads((ROOT / "envConfig.json").read_text())
        env["uq_method"] = method
        Path("envConfig.json").write_text(json.dumps(env))
        os.makedirs("ws/checkpoints")
        shutil.copy(ckpt, "ws/checkpoints/ngp_ep0001.ckpt")
        argv = [data_dir, "--workspace", "ws", "--bound", "1", "--scale",
                "1", "--seed", "0", "-O", "--ff", "--num_steps",
                str(UNCERTAIN_STEPS)]
        fits = []
        places = Places(torch.cuda.synchronize, fused_mlp, [
            ("render", R, "render"), ("fits", BayesianLaplace, "map_fit"),
            ("lm", TH, "levenberg_marquardt"),
            ("fit", BayesianLaplace, "fit")],
            hooks={"fit": (None, fits.append)})
        fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
        plain0 = fused_mlp.PLAIN_CALLS + fused_mlp.PLAIN_CALLS_GROUPED
        t0 = time.perf_counter()
        res = U.main(argv, device="cuda")
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        plain = fused_mlp.PLAIN_CALLS + fused_mlp.PLAIN_CALLS_GROUPED - plain0
        launches, f32 = fused_mlp.LAUNCHES, fused_mlp.LAUNCHES_F32
        places.restore()
        views = len(os.listdir(os.path.join(data_dir, "train")))
        key = "trace" if method == LAPLACE else "optimized_mu_d"
        vals = np.asarray(res[key if method == LAPLACE
                              else "optimized_sigma_d"], dtype=np.float64)
        stats = dict(method=method, views=views, wall_s=t_all,
                     render_s=places.s["render"] / views,
                     launches=launches,
                     launches_render=places.k4["render"],
                     heatmap=os.path.exists(
                         "results/uncertainty_heatmap.png"))
        check(plain == 0 and f32 == 0, f"uncertain ({method}): plain "
              f"versions called {plain} times, K4 f32 launched {f32}")
        check(places.k4["render"] >= 2 * views, f"uncertain ({method}): "
              f"K4 launched {places.k4['render']} times in the renders")
        if method == LAPLACE:
            steps = sum(bl.fit_steps * bl.num_perturbations for bl in fits)
            rmv = np.asarray(res["rmv"], dtype=np.float64)
            stats.update(
                fits_s=places.s["fits"] / views, lm_s=places.s["lm"] / views,
                inverse_etc_s=(places.s["fit"] - places.s["fits"]
                               - places.s["lm"]) / views,
                adam_steps=steps, launches_fits=places.k4["fits"],
                launches_lm=places.k4["lm"], trace=res["trace"],
                rmv=res["rmv"],
                finite=float(np.isfinite(vals).mean()),
                n_theta=int(fits[-1].theta.shape[0]))
            check(len(fits) == views and places.k4["fits"] >= steps,
                  f"uncertain: K4 launched {places.k4['fits']} times in "
                  f"{steps} Adam steps of {len(fits)} fits")
            check(stats["heatmap"], "uncertain: the heat map was not written")
            check(stats["finite"] == 1.0 and bool(np.isfinite(rmv).all()),
                  f"uncertain: a view's trace or rmv is not finite "
                  f"(trace {res['trace']}, rmv {res['rmv']})")
            # K4 against the plain chain on the last fit's points: at its
            # posterior mean where finite, and at the net's own weights
            bl = fits[-1]
            cmp = {}
            for where, theta in (("posterior mean", bl.posterior_mean),
                                 ("the net's", bl.net.get_sigma_net_flat())):
                if not bool(torch.isfinite(theta).all()):
                    continue
                n0 = fused_mlp.LAUNCHES
                lk, gk = _nlp_and_grad(torch, bl, theta, False)
                check(fused_mlp.LAUNCHES == n0 + 1, "the nlp check did not "
                      "launch K4")
                lp, gp = _nlp_and_grad(torch, bl, theta, True)
                cmp[where] = dict(
                    loss=lk, loss_plain=lp,
                    loss_rel=abs(lk - lp) / max(abs(lp), 1e-30),
                    grad_rel=float((gk - gp).abs().max()
                                   / gp.abs().max().clamp(min=1e-30)))
            stats["k4_vs_plain"] = cmp
            for where, c in cmp.items():
                print(f"uncertain: -log posterior at {where} theta through "
                      f"K4 {c['loss']:.8g} vs plain {c['loss_plain']:.8g} "
                      f"(rel {c['loss_rel']:.3e}), gradient max "
                      f"{c['grad_rel']:.3e} of its largest (bounds "
                      f"{TOL_LAPLACE})", flush=True)
                check(c["loss_rel"] <= TOL_LAPLACE["loss"]
                      and c["grad_rel"] <= TOL_LAPLACE["grad"],
                      f"uncertain: the fit through K4 disagrees with the "
                      f"plain chain at {where} theta")
        else:
            stats.update(mu_d=res["optimized_mu_d"],
                         sigma_d=res["optimized_sigma_d"])
        print(f"uncertain -O --ff ({method}): " + json.dumps(stats)
              + f"; {smi}", flush=True)
        return stats
    finally:
        if places is not None:
            places.restore()
        os.chdir(old)
        shutil.rmtree(work, ignore_errors=True)


def laplace_k4_checks(torch, eng, smi):
    """The start's in-scan Laplace UQ of LAPLACE_SIMS['mc'] sims (the same
    observation, each its own draws from a generator seeded 0) through
    the grouped kernel and through the plain chain (`plain_k4`): the -log
    posterior and its gradient at the draws' theta (TOL_LAPLACE); the MAP
    thetas' gap (printed: Adam's normalised steps part where a bf16
    rounding flips); the LM from the plain route's MAP theta on both
    routes, at least LAPLACE_FINITE of the sims finite, lmbda and the
    stops equal, x and g within TOL_LAPLACE_LM; trace and rmv printed
    (they read g only through g's share of (g g^T + 1e-2 I)^-1, which
    hardly moves with g)."""
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    from nerfsafetyvalidation_tpu_torch.uq.bayesian_laplace import (
        nlp_and_grad)
    m = LAPLACE_SIMS["mc"]
    states = eng.start_state.expand(m, 12)
    with torch.no_grad():
        X, y = eng._render_laplace(states)
    theta0, perts = eng._laplace_draws(
        torch.Generator(device=eng.device).manual_seed(0), m)
    h = eng.net.encode_pos(X)
    out = {}
    for plain in (True, False):
        n0 = fused_mlp.LAUNCHES_GROUPED
        with plain_k4(fused_mlp) if plain else contextlib.nullcontext():
            loss, g0 = nlp_and_grad(eng.net, theta0, h, y, 0.0,
                                    eng.laplace_prior_std)
            theta = eng._laplace_map(X, y, theta0, perts)
            lm = eng._laplace_lm(out[True]["theta"] if not plain else theta,
                                 X, y)
            trace, rmv = eng._laplace_uq(X, y, theta0, perts)
        torch.cuda.synchronize()
        check((fused_mlp.LAUNCHES_GROUPED > n0) != plain,
              "the grouped K4 ran on the plain route or not on the "
              "kernel's")
        out[plain] = dict(loss=loss, g0=g0, theta=theta, lm=lm,
                          trace=trace, rmv=rmv)
    k, p = out[False], out[True]
    ok = torch.isfinite(p["loss"]) & torch.isfinite(k["loss"])
    loss_rel = float(((k["loss"] - p["loss"]).abs() / p["loss"].abs())[ok]
                     .max()) if bool(ok.any()) else 0.0
    grad_rel = float(((k["g0"] - p["g0"]).abs().amax(dim=1)
                      / p["g0"].abs().amax(dim=1))[ok].max()) \
        if bool(ok.any()) else 0.0
    (xk, gk, lk, dk), (xp, gp, lp, dp) = k["lm"], p["lm"]

    def finite(*ts):
        return torch.stack([torch.isfinite(t).flatten(1).all(1)
                            for t in ts]).all(0)
    fin = finite(xp, gp)
    same_fin = bool(torch.equal(fin, finite(xk, gk)))
    same_steps = bool(torch.equal(dk, dp)) and bool(torch.allclose(
        lk, lp, rtol=1e-6, atol=0.0))

    def worst(a, b):
        return float(((a - b).abs().amax(dim=1)
                      / b.abs().amax(dim=1).clamp(min=1e-30))[fin].max()) \
            if bool(fin.any()) else 0.0
    lm_rel = dict(x=worst(xk, xp), g=worst(gk, gp),
                  g_norm=float((gk.norm(dim=1) / gp.norm(dim=1) - 1)
                               .abs()[fin].max()) if bool(fin.any()) else 0.0)
    gap = (k["theta"] - p["theta"]).abs()
    rec = dict(start_finite_loss=int(ok.sum()), start_loss_rel=loss_rel,
               start_grad_rel=grad_rel, map_gap_max=float(
                   gap.nan_to_num().max()),
               map_within_1e4=float((gap <= 1e-4).float().mean()),
               lm_finite=int(fin.sum()), lm_same_steps=same_steps,
               lm_rel=lm_rel, g_norm=gp.norm(dim=1).tolist(),
               trace=k["trace"].tolist(), rmv=k["rmv"].tolist(),
               trace_plain=p["trace"].tolist(), rmv_plain=p["rmv"].tolist())
    print(f"validate --ff MC, the start's in-scan Laplace of {m} sims, "
          f"grouped K4 vs plain: -log posterior at theta0 max rel "
          f"{loss_rel:.3e}, gradient {grad_rel:.3e} of its largest "
          f"({rec['start_finite_loss']} of {m} finite; bounds "
          f"{TOL_LAPLACE}); MAP theta gap max {rec['map_gap_max']:.3e}, "
          f"{rec['map_within_1e4']:.4f} within 1e-4; LM from the plain "
          f"MAP theta: {rec['lm_finite']} of {m} finite (same sims: "
          f"{same_fin}), lmbda and stops equal: {same_steps}, x / g / "
          f"|g| rel { {a: f'{b:.3e}' for a, b in lm_rel.items()} } (bounds "
          f"{TOL_LAPLACE_LM}), |g| {rec['g_norm']}; trace {rec['trace']} "
          f"(plain {rec['trace_plain']}), rmv {rec['rmv']} (plain "
          f"{rec['rmv_plain']}); {smi}", flush=True)
    check(loss_rel <= TOL_LAPLACE["loss"] and grad_rel <= TOL_LAPLACE["grad"],
          "validate --ff MC: the fits' loss through the grouped K4 "
          "disagrees with the plain chain")
    check(rec["lm_finite"] >= LAPLACE_FINITE * m and same_fin
          and same_steps and all(lm_rel[a] <= b
                                 for a, b in TOL_LAPLACE_LM.items()),
          "validate --ff MC: the in-scan LM through the grouped K4 "
          "disagrees with the plain chain")
    return {"laplace_k4": rec}


def laplace_finite_checks(torch, calls, what):
    """The in-scan Laplace UQ calls of one run, `calls` = [(engine, X, y,
    theta0, perts, trace, rmv)]: every fit whose trace or rmv is not finite
    must be explained, by an overflowing start (the -log posterior at the
    drawn theta0 not finite on X or on one of its moved copies, ROADMAP
    Queue 3) or by points or densities that were not finite already (a
    sim whose earlier NaN reward scaled its disturbances), the latter only
    after an overflowing start. Returns the fits' finite share and the
    counts."""
    n_fits = n_fin = n_over = n_nan_in = 0
    for eng, X, y, theta0, perts, trace, rmv in calls:
        bad_in = ~(torch.isfinite(X).flatten(1).all(1)
                   & torch.isfinite(y).all(1))
        over = torch.zeros_like(bad_in)
        with torch.no_grad():
            for Xc in [X] + [X + perts[:, c] * eng.laplace_scale
                             for c in range(perts.shape[1])]:
                f = eng._laplace_nlp(theta0, eng.net.encode_pos(Xc), y)
                over |= ~torch.isfinite(f)
        over &= ~bad_in
        nf = ~(torch.isfinite(trace) & torch.isfinite(rmv))
        unexplained = int((nf & ~over & ~bad_in).sum())
        check(unexplained == 0, f"{what}: {unexplained} in-scan Laplace "
              "fits are not finite from a finite start that did not "
              "overflow")
        check(not bool(bad_in.any()) or n_over > 0, f"{what}: a sim's "
              "points are not finite before any fit overflowed")
        n_fits += int(nf.numel())
        n_fin += int((~nf).sum())
        n_over += int(over.sum())
        n_nan_in += int(bad_in.sum())
    return dict(fits=n_fits, fits_finite=n_fin / max(n_fits, 1),
                overflowed_starts=n_over, nan_inputs=n_nan_in)


def laplace_sequential_phase(torch, V, data_dir, ckpt, smi):
    """Phase 28a: validate's sequential Monte Carlo with the Laplace UQ,
    envConfig as shipped but the uq_method and LAPLACE_SIMS['sequential']
    sims, --camera nerf, the first SEQ_STEPS steps of the flight (6
    before), on VALIDATE_UNFUSED's net (no kernel): seconds
    per sim-step by part (the UQ's render, its MAP fits on every pixel's
    point, LM, the rest of the fit: the inverse), the CSV's rmv and reward
    (at least LAPLACE_FINITE of the rmv finite). Returns its numbers."""
    import random
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    from nerfsafetyvalidation_tpu_torch.uq import hessian as TH
    from nerfsafetyvalidation_tpu_torch.uq.bayesian_laplace import (
        BayesianLaplace)
    old, work = os.getcwd(), tempfile.mkdtemp()
    os.chdir(work)
    places = lp = None
    real_generate = V.generate_path
    try:
        env = json.loads((ROOT / "envConfig.json").read_text())
        env.update(n_simulations=LAPLACE_SIMS["sequential"],
                   uq_method=LAPLACE)
        Path("envConfig.json").write_text(json.dumps(env))
        argv = [data_dir, "--workspace", "ws", "--bound", "1", "--scale",
                "1", "--seed", "0", "--num_steps", str(VALIDATE_STEPS),
                "--camera", "nerf"]
        write_net_sdf(torch, argv, ckpt)
        draws = []

        def generate(*ranges):
            # a restart on a NaN state (int(nan) in the SDF check is a
            # ValueError, which the restart loop takes for a missing path)
            # would repeat: the phase stops after LAPLACE_RESTARTS
            draws.append(ranges)
            if len(draws) > 1 + LAPLACE_RESTARTS:
                raise PhaseStop(f"{len(draws) - 1} restarts")
            return real_generate(*ranges)
        V.generate_path = generate
        places = sequential_places(torch, fused_mlp)
        lp = Places(torch.cuda.synchronize, fused_mlp, [
            ("fits", BayesianLaplace, "map_fit"),
            ("lm", TH, "levenberg_marquardt"),
            ("fit", BayesianLaplace, "fit")])
        random.seed(0)
        fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
        fused_mlp.LAUNCHES_GROUPED = 0
        t0 = time.perf_counter()
        stopped = None
        try:
            with mc_horizon(V, SEQ_STEPS):
                V.main(argv, device="cuda")
        except PhaseStop as e:
            stopped = str(e)
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        k4 = (fused_mlp.LAUNCHES + fused_mlp.LAUNCHES_F32
              + fused_mlp.LAUNCHES_GROUPED)
        path = (f"results/collisionValuesBlenderMC_n"
                f"{LAPLACE_SIMS['sequential']}.csv")
        rows = list(csv.reader(open(path, newline=""))) \
            if os.path.exists(path) else []
        n = max(len(rows), 1)
        check(all(len(r) == 24 for r in rows),
              "sequential MC (Laplace): the CSV's rows are not of 24 columns")
        check(stopped is None or lp.s["fit"] > 0, "sequential MC (Laplace):"
              f" stopped ({stopped}) before a Laplace fit ran")
        per = {k: places.s[k] / n for k in ("camera", "observation",
                                            "uq render", "fit", "hessian",
                                            "replan", "step")}
        per.update(uq_fits=lp.s["fits"] / n, uq_lm=lp.s["lm"] / n,
                   uq_inverse_etc=(lp.s["fit"] - lp.s["fits"]
                                   - lp.s["lm"]) / n)
        rmv = np.asarray([float(r[21]) for r in rows])
        reward = np.asarray([float(r[20]) for r in rows])
        stats = dict(wall_s=t_all, sim_steps=len(rows), s_per_sim_step=per,
                     rmv=rmv.tolist(), reward=reward.tolist(),
                     finite=float(np.isfinite(rmv).mean()) if rows else 0.0,
                     k4=k4, restarts=len(draws) - 1, stopped=stopped)
        print(f"sequential MC with the Laplace UQ ({len(draws) - 1} "
              f"restarts, stopped: {stopped}): {len(rows)} sim-steps in "
              f"{t_all:.2f} s; seconds per sim-step "
              f"{ {k: round(v, 4) for k, v in per.items()} }; rmv "
              f"{stats['rmv']}; reward (the previous step's) "
              f"{stats['reward']}; K4 launches {k4}; {smi}", flush=True)
        check(k4 == 0, "sequential MC (Laplace) launched K4 on the CLI's "
              "unfused float32 net")
        check(stats["finite"] >= LAPLACE_FINITE, f"sequential MC (Laplace): "
              f"fewer than {LAPLACE_FINITE} of the rmv values are finite")
        return stats
    finally:
        for p in (places, lp):
            if p is not None:
                p.restore()
        V.generate_path = real_generate
        os.chdir(old)
        shutil.rmtree(work, ignore_errors=True)


def laplace_phases(torch, fused_mlp, V, root, ckpt_ff, ckpt_unfused,
                   val_dir, smi):
    """Phases 25-28 (the Bayesian-Laplace UQ); returns their numbers, the
    grouped kernel's for the kernels line."""
    from nerfsafetyvalidation_tpu_torch.data.synthetic import (
        generate_dataset, write_dataset)
    st = {}
    with Phase("kernel K4 grouped"):
        st["k4_grouped"] = k4_grouped_phase(torch, fused_mlp, smi)
    unc_dir = str(Path(root) / "uncertain")
    write_dataset(unc_dir, generate_dataset(
        n_train=UNCERTAIN_VIEWS, n_val=1, n_test=1, H=VALIDATE_RES,
        W=VALIDATE_RES), split_dirs=True)
    for method, name in ((LAPLACE, "laplace"), (GAUSSIAN, "gaussian")):
        with Phase(f"uncertain --ff {name}"):
            st[f"uncertain {name}"] = uncertain_phase(torch, unc_dir,
                                                      ckpt_ff, method, smi)
    with Phase("validate --ff MC laplace"):
        st["validate --ff MC laplace"] = validate_phase(
            torch, V, val_dir, ["--ff"], "Monte Carlo", LAPLACE_SIMS["mc"],
            ckpt_ff, smi, uq_method=LAPLACE)
    with Phase("sequential MC laplace"):
        st["sequential MC laplace"] = laplace_sequential_phase(
            torch, V, val_dir, ckpt_unfused, smi)
    with Phase("validate --closed_loop laplace"):
        st["validate --closed_loop laplace"] = validate_phase(
            torch, V, val_dir, ["--closed_loop", "--closed_loop_uq",
                                "laplace"], "Monte Carlo",
            LAPLACE_SIMS["closed_loop"], ckpt_unfused, smi)
    return st


# ---- validate --fast_render and --r (phases 29-32) ------------------------
# the cell encode's points (phase 29): one ENCODE_CHUNK
CELL_POINTS = 131072
# The cell table built on the card against the CPU's build: the same
# integer hashes, the same numpy cell draws, and each row's winner picked
# by a scatter-max, so the same bits (checked exactly). The cell encode on
# the card against the CPU's, and the cell encode against the corner
# encode on the dense levels (the same eight features and weights): each
# sums eight products in an order of its own, a float32 step of the
# features (|f| <= ~1e-4 .. 1 on a trained table) each; bound 1e-6
# absolute. With the bf16 table the f32 sum is rounded to bf16 once: a
# last-bit difference of the sum can move it one bf16 step; bound 2^-8 of
# max(|f|, 2^-10).
TOL_CELL = {"torch.float32": 1e-6, "torch.bfloat16": 2 ** -8}
# phase 30: --ff --fast_render --batched_rollouts MC on phase 19's net,
# the default observation (uniform, through run_grid) and scout
FAST_RENDER_RUNS = (("uniform", []),
                    ("scout", ["--batched_obs_render", "scout"]))
FAST_RENDER_SIMS = 16
# phase 31: chunks of pose 0's render_grid_staged frame on the card and
# on the CPU from the same net, cell table and occupancy state: the march
# is IEEE additions, products, quotients and floors (the same samples on
# both), the field's float32 products are summed in other orders (cuBLAS
# and the CPU's: ~1e-6 relative), exp may differ in its last bit. Stated
# before the first run: TOL_STAGED["K4 f32"]'s bounds (image max 1e-4 and
# mean 1e-6, rgbs 1e-4, sigmas 1e-4 of max(|sigma|, 1)).
FAST_RENDER_CHUNKS = (76, 80)
TOL_GRID_CPU = TOL_STAGED["K4 f32"]
# phase 31 flies its sim's first FR_SEQ_STEPS steps: each renders two
# render_grid_staged frames of 12-17 s at 800^2 on an H100 (PERF.md
# section 5), so the depth is cut to keep phases 29-32 within their
# 150-s budget
FR_SEQ_STEPS = 1
# phase 32 replays the cross-entropy CSV from its simulation REPLAY_CEM_ITER
# on (--iter: the replay appends to the replay CSV and keeps the others'
# rows), the same depth cut
REPLAY_CEM_ITER = 1


def cell_layout_phase(torch, data_dir, runs, smi):
    """Phase 29: the cell table of each CLI net (runs: name -> (flags,
    checkpoint)) built on the card and on the CPU (bit-equal), the cell
    encode of CELL_POINTS seeded points (a tenth outside the box) on the
    card against the CPU's (TOL_CELL), and against the corner encode on
    the dense levels (TOL_CELL); the table's MB, the build's ms, and the
    cell and corner encodes' device ms. Returns their numbers."""
    from nerfsafetyvalidation_tpu_torch.ops import hash_encoding as H
    out = {}
    for name, (flags, ckpt) in runs.items():
        old, work = os.getcwd(), tempfile.mkdtemp()
        os.chdir(work)
        try:
            net, _ = load_cli_net(torch, [data_dir, "--bound", "1",
                                          "--scale", "1", *flags], ckpt)
        finally:
            os.chdir(old)
            shutil.rmtree(work, ignore_errors=True)
        spec, bound, dt = net.grid_spec, net.cfg.bound, net.compute_dtype
        tol = TOL_CELL[str(dt)]
        with torch.no_grad():
            table_c = net.table
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cell = H.build_cell_table(table_c, spec)
            torch.cuda.synchronize()
            build_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            cell_cpu = H.build_cell_table(table_c.cpu(), spec)
            build_cpu_s = time.perf_counter() - t0
            ibits = torch.int16 if dt == torch.bfloat16 else torch.int32
            same = torch.equal(cell.cpu().view(ibits), cell_cpu.view(ibits))
            gen = torch.Generator(device="cuda").manual_seed(0)
            x = (torch.rand((CELL_POINTS, 3), generator=gen, device="cuda")
                 * 2.0 - 1.0) * bound
            x[: CELL_POINTS // 10] *= 1.2
            enc = H.hash_grid_encode_cell(cell, x, spec, bound=bound)
            enc_cpu = H.hash_grid_encode_cell(cell_cpu, x.cpu(), spec,
                                              bound=bound)
            corner = H.hash_grid_encode(table_c, x, spec, bound=bound)
            dense = [c for lvl in range(spec.num_levels)
                     if not spec.use_hash[lvl]
                     for c in range(lvl * spec.level_dim,
                                    (lvl + 1) * spec.level_dim)]

            def err(got, want):
                got, want = got.float().cpu(), want.float().cpu()
                scale = 1.0 if dt == torch.float32 \
                    else want.abs().clamp(min=2 ** -10)
                return float(((got - want).abs() / scale).max())
            e_cpu = err(enc, enc_cpu)
            e_dense = err(enc[:, dense], corner[:, dense]) if dense \
                else float("nan")
            zero_oob = bool((enc[(x.abs() > bound).any(-1)] == 0).all())
            cell_ms = cuda_ms(torch, lambda: H.hash_grid_encode_cell(
                cell, x, spec, bound=bound), 10)
            corner_ms = cuda_ms(torch, lambda: H.hash_grid_encode(
                table_c, x, spec, bound=bound), 10)
        mb = cell.numel() * cell.element_size() / 1e6
        rec = dict(rows=int(cell.shape[0]), width=int(cell.shape[1]),
                   dtype=str(dt), mb=mb, build_ms=build_ms,
                   build_cpu_s=build_cpu_s, bit_equal=same,
                   err_card_cpu=e_cpu, err_dense_vs_corner=e_dense,
                   dense_levels=len(dense) // spec.level_dim,
                   cell_ms=cell_ms, corner_ms=corner_ms)
        out[name] = rec
        print(f"cell layout, {name} ({type(net).__name__}, {dt}): table "
              f"[{rec['rows']}, {rec['width']}] {mb:.1f} MB, built in "
              f"{build_ms:.2f} ms on the card ({build_cpu_s:.2f} s on the "
              f"CPU), bit-equal {same}; encode of {CELL_POINTS} points card "
              f"vs CPU max {e_cpu:.3e}, cell vs corner on the "
              f"{rec['dense_levels']} dense levels max {e_dense:.3e} "
              f"(bound {tol}); cell encode {cell_ms:.4f} ms, corner "
              f"{corner_ms:.4f} ms; {smi}", flush=True)
        check(same, f"cell layout, {name}: the card's table differs from "
              "the CPU's")
        check(e_cpu <= tol and e_dense <= tol and zero_oob and dense,
              f"cell layout, {name}: the cell encode is off (or the net "
              "has no dense level)")
        del net, cell, cell_cpu
    return out


def _fresh_workdir(src=None, env_extra=None):
    """A temporary working directory (made current) with envConfig.json
    (env_extra's keys changed); from `src` (a phase's kept directory) the
    SDF and the planner's pose cache, so that reset skips learn_init.
    Returns (the old directory, the new one)."""
    old, work = os.getcwd(), tempfile.mkdtemp()
    os.chdir(work)
    env = json.loads((ROOT / "envConfig.json").read_text())
    env.update(env_extra or {})
    Path("envConfig.json").write_text(json.dumps(env))
    if src is not None:
        for d in ("paths", "cached"):
            if Path(src, d).exists():
                shutil.copytree(Path(src, d), d)
        os.makedirs("validation/utils", exist_ok=True)
        shutil.copy(Path(src, "validation/utils/sdf.npy"),
                    "validation/utils/sdf.npy")
    return old, work


def fast_render_batched_phase(torch, V, data_dir, ckpt, src, smi):
    """Phase 30: `validate --ff --fast_render --batched_rollouts` Monte
    Carlo (FAST_RENDER_SIMS sims, the plan's steps) on phase 19's net, in
    a working directory with phase 19's pose cache (`src`), once a
    FAST_RENDER_RUNS observation: K4 launched in the observations, the
    refresh and A*, its plain version never; rollouts/s, the collision
    rate, sigma_d's range, the CSV's rows. Returns their numbers."""
    import random
    from nerfsafetyvalidation_tpu_torch.models import renderer as R
    from nerfsafetyvalidation_tpu_torch.models.network import NeRFNetwork
    from nerfsafetyvalidation_tpu_torch.nav.planner import Planner
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    from nerfsafetyvalidation_tpu_torch.validation.batched import (
        FullBatchedRolloutEngine)
    old, work = _fresh_workdir(src, dict(n_simulations=FAST_RENDER_SIMS,
                                         stress_test="Monte Carlo"))
    out, places = {}, None
    real_generate = V.generate_path
    try:
        draws = []

        def generate(*ranges):
            draws.append(ranges)
            check(len(draws) <= 1 + MAX_RESTARTS, "validate --fast_render: "
                  f"more than {MAX_RESTARTS} 'Path not found' restarts")
            return real_generate(*ranges)
        V.generate_path = generate
        argv = [data_dir, "--workspace", "ws", "--bound", "1", "--scale",
                "1", "--seed", "0", "--batched_rollouts", "--num_steps",
                str(VALIDATE_STEPS), "--ff", "--fast_render"]
        if src is None:
            write_net_sdf(torch, argv, ckpt)
        else:
            load_cli_net(torch, argv, ckpt)
        from nerfsafetyvalidation_tpu_torch.data.provider import NeRFDataset
        test_pose = NeRFDataset(V.apply_O_flag(V.build_parser(
            "validate").parse_args(argv), "validate"), type="test",
            device="cuda").poses[0]
        for name, extra in FAST_RENDER_RUNS:
            for f in Path("results").glob("*.csv") if Path(
                    "results").exists() else []:
                f.unlink()
            places = Places(torch.cuda.synchronize, fused_mlp, [
                ("astar", Planner, "a_star_init"),
                ("learn_init", Planner, "learn_init"),
                ("refresh", R, "update_extra_state"),
                ("to_cell", NeRFNetwork, "to_cell"),
                ("observations", FullBatchedRolloutEngine, "_render_stats"),
                ("run", FullBatchedRolloutEngine, "monte_carlo")])
            random.seed(0)
            draws.clear()
            fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
            plain0 = fused_mlp.PLAIN_CALLS
            t0 = time.perf_counter()
            res = V.main(argv + extra, device="cuda")
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
            places.restore()
            k4_all, k4_f32 = fused_mlp.LAUNCHES, fused_mlp.LAUNCHES_F32
            plain = fused_mlp.PLAIN_CALLS - plain0
            eng = places.last["run"]
            rows = list(csv.reader(open(
                f"results/collisionValuesBatchedMC_n{FAST_RENDER_SIMS}.csv",
                newline="")))
            sig = res["sigma_d"]
            # the occupancy grid, and the start's observation: the UQ's
            # inputs and the share of pixels that are not background
            rs = eng.renderer_state
            occupied = float(popcount(torch, rs.density_bitfield)) / (
                8 * rs.density_bitfield.numel())
            def not_background(poses):
                obs = eng._obs_call()(*eng._obs_rays(poses))
                return obs, float((obs["image"].reshape(-1, 3).amin(-1)
                                   < 0.99).float().mean())
            with torch.inference_mode():
                obs, hit = not_background(eng._pose_from_state(
                    eng.start_state[None]))
                start_stats = eng._obs_stats(obs)[0].tolist()
                # the same observation from the test view's pose, which
                # looks at the scene
                _, hit_view = not_background(torch.as_tensor(
                    test_pose, device="cuda")[None])
            st = dict(wall_s=t_all, restarts=len(draws) - 1,
                      run_s=places.s["run"],
                      rollouts_per_s=FAST_RENDER_SIMS / places.s["run"],
                      steps=int(eng.steps), obs_render=eng.obs_render,
                      state=eng.renderer_state is not None,
                      k4={k: places.k4[k] for k in (
                          "astar", "learn_init", "refresh", "observations")},
                      k4_all=k4_all, k4_f32=k4_f32, plain_calls=plain,
                      seconds={k: places.s[k] for k in (
                          "astar", "learn_init", "refresh", "to_cell",
                          "observations")},
                      collision_rate=float(res["collided"].any(1).mean()),
                      sigma_d=[float(np.nanmin(sig)), float(np.nanmax(sig))],
                      csv_rows=len(rows), grid_occupied=occupied,
                      mean_density=float(rs.mean_density),
                      start_obs_stats=start_stats, start_obs_hit=hit,
                      test_view_obs_hit=hit_view)
            out[name] = st
            print(f"validate --ff --fast_render {name} MC ({FAST_RENDER_SIMS}"
                  f" sims x {st['steps']} steps): {st['rollouts_per_s']:.3f}"
                  f" rollouts/s ({st['run_s']:.3f} s), wall {t_all:.2f} s, "
                  f"{st['restarts']} restarts; "
                  f"seconds {({k: round(v, 3) for k, v in st['seconds'].items()})}"
                  f"; K4 launches {st['k4']} (all {st['k4_all']}, f32 "
                  f"{st['k4_f32']}), plain calls {st['plain_calls']}; "
                  f"collision rate {st['collision_rate']}; sigma_d "
                  f"{st['sigma_d']}; CSV {len(rows)} rows; the grid "
                  f"{occupied:.4f} occupied (mean density "
                  f"{st['mean_density']:.4g}); the start's observation: "
                  f"{hit:.4f} of its pixels not background, UQ inputs "
                  f"[S_c2d2, S_cd, mean image, mean and std of sigma] "
                  f"{start_stats}; from the test view's pose {hit_view:.4f}"
                  f" of its pixels not background; {smi}", flush=True)
            check(st["obs_render"] == name and st["state"],
                  f"--fast_render {name}: the engine has no occupancy state")
            check(st["plain_calls"] == 0 and st["k4_f32"] == 0,
                  f"--fast_render {name}: K4's plain version or f32 kernel "
                  "ran")
            check(st["k4"]["observations"] > 0 and st["k4"]["refresh"] > 0
                  and st["k4"]["astar"] > 0,
                  f"--fast_render {name}: K4 launches {st['k4']}")
            check(rows and all(len(r) == 23 for r in rows)
                  and bool(np.isfinite(sig).all() and (sig >= 0).all())
                  and bool(np.isfinite(res["reward"]).all()),
                  f"--fast_render {name}: the CSV, sigma_d or the reward")
            check(hit_view > 0.0, f"--fast_render {name}: the observation "
                  "from the test view's pose shades nothing")
        return out
    finally:
        if places is not None:
            places.restore()
        V.generate_path = real_generate
        os.chdir(old)
        shutil.rmtree(work, ignore_errors=True)


def fast_render_sequential_phase(torch, V, data_dir, ckpt, src, keep, smi):
    """Phase 31: validate's sequential Monte Carlo with --fast_render
    (envConfig as shipped, SEQ_SIMS sim, its first FR_SEQ_STEPS steps, --camera
    nerf, 64 samples a ray for the camera's staged frame) on phase 20's
    float32 net, with phase 22's pose cache (`src`, when given): seconds
    per sim-step by part, render_fn's frame seconds and rays/s, no K4
    launch; then the fast frame of the test view's pose against the
    staged frame's PSNR on that view, and FAST_RENDER_CHUNKS of it through
    render_grid_staged on the card and on the CPU (TOL_GRID_CPU). The
    working directory is copied to `keep` for the replay. Returns the
    numbers."""
    import copy
    import random
    from nerfsafetyvalidation_tpu_torch.data.provider import NeRFDataset
    from nerfsafetyvalidation_tpu_torch.data.rays import get_rays
    from nerfsafetyvalidation_tpu_torch.models import make_network
    from nerfsafetyvalidation_tpu_torch.models import renderer as R
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    old, work = _fresh_workdir(src, dict(n_simulations=SEQ_SIMS))
    places, real_grid = None, R.render_grid_staged
    try:
        argv = [data_dir, "--workspace", "ws", "--bound", "1", "--scale",
                "1", "--seed", "0", "--num_steps", str(VALIDATE_STEPS),
                "--camera", "nerf", "--fast_render"]
        if src is None:
            write_net_sdf(torch, argv, ckpt)
        else:
            load_cli_net(torch, argv, ckpt)
        seen = {}

        def grid(net, state, rays_o, rays_d, **kw):
            seen.update(net=net, state=state, kw=kw)
            return real_grid(net, state, rays_o, rays_d, **kw)
        R.render_grid_staged = grid
        places = sequential_places(torch, fused_mlp)
        random.seed(0)
        fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
        t0 = time.perf_counter()
        with mc_horizon(V, FR_SEQ_STEPS):
            V.main(argv, device="cuda")
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        R.render_grid_staged = real_grid
        places.restore()
        k4 = fused_mlp.LAUNCHES + fused_mlp.LAUNCHES_F32
        rows = list(csv.reader(open(
            f"results/collisionValuesBlenderMC_n{SEQ_SIMS}.csv", newline="")))
        n = len(rows)
        per = _seq_times(places, n)
        view, state, kw = seen["net"], seen["state"], seen["kw"]
        net = places.last["reset"].net
        opt = V.apply_O_flag(V.build_parser("validate").parse_args(argv),
                             "validate")
        ds = NeRFDataset(opt, type="test", device="cuda")
        H, W = ds.H, ds.W
        gt = ds.images[0].numpy().astype(np.float64)
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
        rays = get_rays(ds.poses[:1], ds.intrinsics, H, W, device="cuda")

        def psnr(img):
            pred = img.reshape(H, W, 3).cpu().numpy().astype(np.float64)
            return float(-10.0 * np.log10(max(np.mean((pred - gt) ** 2),
                                              1e-10)))
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fast = R.render_grid_staged(view, state, rays["rays_o"],
                                        rays["rays_d"], **kw)
            torch.cuda.synchronize()
            t_fast = time.perf_counter() - t0
            t0 = time.perf_counter()
            staged = R.render(net, rays["rays_o"], rays["rays_d"],
                              staged=True, bg_color=1.0,
                              num_steps=VALIDATE_STEPS,
                              max_ray_batch=opt.max_ray_batch)
            torch.cuda.synchronize()
            t_staged = time.perf_counter() - t0
            # chunks of the frame on the card and on the CPU
            mrb = kw["max_ray_batch"]
            a, b = (c * mrb for c in FAST_RENDER_CHUNKS)
            ro, rd = rays["rays_o"][:, a:b], rays["rays_d"][:, a:b]
            card = R.render_grid_staged(view, state, ro, rd, **kw)
            net_cpu = make_network(net.cfg, {
                k: ([w.cpu() for w in v] if isinstance(v, list) else
                    {kk: vv.cpu() for kk, vv in v.items()})
                for k, v in net.params_tree().items()}, device="cpu")
            view_cpu = copy.copy(net_cpu)
            view_cpu.cell_table = view.cell_table.cpu()
            state_cpu = R.RendererState(
                density_bitfield=state.density_bitfield.cpu(),
                skip_grid=state.skip_grid.cpu())
            t0 = time.perf_counter()
            cpu = R.render_grid_staged(view_cpu, state_cpu, ro.cpu(),
                                       rd.cpu(), **kw)
            t_cpu = time.perf_counter() - t0
        img = (card["image"].cpu() - cpu["image"]).abs()
        rgbs = float((card["rgbs"].cpu() - cpu["rgbs"]).abs().max())
        sig = float(((card["sigmas"].cpu() - cpu["sigmas"]).abs()
                     / cpu["sigmas"].abs().clamp(min=1.0)).max())
        hits = int((cpu["sigmas"] > 0).sum())
        st = dict(wall_s=t_all, sim_steps=n, s_per_sim_step=per,
                  frame_s=per["observation"],
                  rays_per_s=H * W / per["observation"],
                  k4=k4, csv_rows=n, render_kw=kw,
                  psnr_fast=psnr(fast["image"]),
                  psnr_staged=psnr(staged["image"]), fast_s=t_fast,
                  staged_s=t_staged, chunks=list(FAST_RENDER_CHUNKS),
                  chunk_img_max=float(img.max()),
                  chunk_img_mean=float(img.mean()), chunk_rgbs=rgbs,
                  chunk_sigma=sig, chunk_samples=hits, chunk_cpu_s=t_cpu)
        print(f"sequential MC --fast_render: {n} sim-steps in {t_all:.2f} "
              f"s; seconds per sim-step "
              f"{ {k: round(v, 4) for k, v in per.items()} }; render_fn "
              f"(render_grid_staged {kw}) {st['frame_s']:.3f} s a frame, "
              f"{st['rays_per_s']:.0f} rays/s; K4 launches {k4}; the test "
              f"view's pose: PSNR {st['psnr_fast']:.3f} dB fast "
              f"({t_fast:.3f} s) vs {st['psnr_staged']:.3f} dB staged at "
              f"{VALIDATE_STEPS} samples ({t_staged:.3f} s); chunks "
              f"{FAST_RENDER_CHUNKS[0]}-{FAST_RENDER_CHUNKS[1] - 1} card vs "
              f"CPU ({hits} shaded samples in the last; CPU {t_cpu:.2f} s): "
              f"image max {st['chunk_img_max']:.3e} mean "
              f"{st['chunk_img_mean']:.3e}, rgbs {rgbs:.3e}, sigmas {sig:.3e}"
              f" (bounds {TOL_GRID_CPU}); {smi}", flush=True)
        check(n > 0 and all(len(r) == 24 for r in rows)
              and all(np.isfinite(float(v)) for r in rows for v in r[2:22]),
              "sequential MC --fast_render: the CSV")
        check(k4 == 0, "sequential MC --fast_render launched K4 on the "
              "CLI's unfused float32 net")
        check(view.cell_table is not None and net.cell_table is None,
              "sequential MC --fast_render: render_fn is not on the cell "
              "view, or the net holds the cell table")
        tol = TOL_GRID_CPU
        check(st["chunk_img_max"] <= tol["image"][0]
              and st["chunk_img_mean"] <= tol["image"][1]
              and rgbs <= tol["rgbs"] and sig <= tol["sigma"] and hits > 0,
              "sequential MC --fast_render: the card's chunks differ from "
              "the CPU's")
        if keep is not None:
            shutil.copytree(work, keep)
        return st
    finally:
        R.render_grid_staged = real_grid
        if places is not None:
            places.restore()
        os.chdir(old)
        shutil.rmtree(work, ignore_errors=True)


def replay_phase(torch, V, data_dir, ckpt, src, smi):
    """Phase 32: `validate --r --camera nerf` on the sequential Monte Carlo
    CSV of `src` (a kept working directory: its path, SDF, pose cache and
    CSVs), and on its cross-entropy CSV where it has one (from simulation
    REPLAY_CEM_ITER on); then envConfig's
    BlenderSimulator through `--batched_rollouts` (the core engine).
    Prints the replay CSV's rows, the eight counts, counts.pkl, both
    confusion PNGs decoded (and their JSON counts). Returns the numbers."""
    import pickle
    import random
    from nerfsafetyvalidation_tpu_torch.data.png import read_png
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    out = {}
    argv = [data_dir, "--workspace", "ws", "--bound", "1", "--scale", "1",
            "--seed", "0", "--num_steps", str(VALIDATE_STEPS), "--camera",
            "nerf"]
    csvs = {"Monte Carlo": f"collisionValuesBlenderMC_n{SEQ_SIMS}.csv",
            "Cross Entropy Method":
                "collisionValuesCEM_m{m}melite{m_elite}k{kmax}.csv".format(
                    **SEQ_CEM)}
    for stress, name in csvs.items():
        if not Path(src, "results", name).exists():
            print(f"replay: {src} has no {name}; the {stress} replay is "
                  "left out", flush=True)
            continue
        with Phase(f"replay {stress}"):
            old, work = _fresh_workdir(src, dict(stress_test=stress,
                                                 n_simulations=SEQ_SIMS))
            try:
                load_cli_net(torch, argv, ckpt)
                os.makedirs("results")
                for f in ("coordinates.json", name):
                    shutil.copy(Path(src, "results", f), "results")
                logged = list(csv.reader(open(f"results/{name}",
                                              newline="")))
                extra = []
                if stress != "Monte Carlo":
                    extra = ["--iter", str(REPLAY_CEM_ITER)]
                    logged = [r for r in logged
                              if int(r[1]) >= REPLAY_CEM_ITER]
                fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
                t0 = time.perf_counter()
                counts = V.main(argv + ["--r"] + extra, device="cuda")
                torch.cuda.synchronize()
                t_all = time.perf_counter() - t0
                rows = list(csv.reader(open(
                    "results/replays/collisionValuesReplay.csv",
                    newline="")))
                pkl = [int(c) for c in pickle.load(open("counts.pkl", "rb"))]
                pngs = {k: read_png(f"results/confusion_matrix_{k}.png")
                        for k in ("step", "traj")}
                conf = {k: json.loads(Path(
                    f"results/confusion_matrix_{k}.json").read_text())[
                        "matrix"] for k in ("step", "traj")}
                st = dict(wall_s=t_all, logged_rows=len(logged),
                          replay_rows=len(rows), counts=[int(c) for c in
                                                         counts],
                          counts_pkl=pkl, matrices=conf,
                          png_shapes={k: list(v.shape)
                                      for k, v in pngs.items()},
                          k4=fused_mlp.LAUNCHES + fused_mlp.LAUNCHES_F32)
                out[stress] = st
                print(f"validate {' '.join(['--r'] + extra)} ({stress}, "
                      f"{len(logged)} logged rows to replay): "
                      f"{len(rows)} replayed rows in {t_all:.2f} s; counts "
                      f"(tp, tn, fp, fn per step, then per trajectory) "
                      f"{st['counts']}; counts.pkl {pkl}; confusion matrices "
                      f"[[tn, fn], [fp, tp]] {conf}; PNGs "
                      f"{st['png_shapes']}; K4 launches {st['k4']}; {smi}",
                      flush=True)
                check(st["counts"] == pkl and rows
                      and all(len(r) == 22 for r in rows)
                      and sum(st["counts"][:4]) == len(logged)
                      and all(v.shape == (256, 256, 3) for v in pngs.values())
                      and st["k4"] == 0, f"validate --r ({stress})")
            finally:
                os.chdir(old)
                shutil.rmtree(work, ignore_errors=True)
    with Phase("validate BlenderSimulator --batched_rollouts"):
        old, work = _fresh_workdir(src, dict(simulator="BlenderSimulator",
                                             n_simulations=FAST_RENDER_SIMS))
        try:
            load_cli_net(torch, argv, ckpt)
            random.seed(0)
            t0 = time.perf_counter()
            res = V.main(argv + ["--batched_rollouts"], device="cuda")
            t_all = time.perf_counter() - t0
            rows = list(csv.reader(open(
                f"results/collisionValuesBatchedMC_n{FAST_RENDER_SIMS}.csv",
                newline="")))
            st = dict(wall_s=t_all, csv_rows=len(rows),
                      collision_rate=float(np.mean(res["ever_collided"])))
            out["BlenderSimulator batched"] = st
            print(f"validate BlenderSimulator --batched_rollouts (the core "
                  f"engine, {FAST_RENDER_SIMS} sims): {t_all:.2f} s, CSV "
                  f"{len(rows)} rows, collision rate {st['collision_rate']};"
                  f" {smi}", flush=True)
            check(len(rows) == FAST_RENDER_SIMS
                  and all(len(r) == 4 for r in rows)
                  and bool(np.isfinite(res["risk"]).all()),
                  "validate BlenderSimulator --batched_rollouts")
        finally:
            os.chdir(old)
            shutil.rmtree(work, ignore_errors=True)
    return out


def fast_render_phases(torch, V, ckpt_ff, ckpt_unfused, val_dir,
                       keep_ff, keep_seq, root, smi):
    """Phases 29-32; keep_ff / keep_seq: phase 19's and phase 22's kept
    working directories (their pose caches; phase 22's CSVs for the
    replay), or None (then the phases plan afresh and the replay reads
    phase 31's CSV). Returns their numbers."""
    st = {}
    with Phase("cell layout"):
        st["cell layout"] = cell_layout_phase(torch, val_dir, {
            "default (phase 20's)": ([], ckpt_unfused),
            "--ff (phase 19's)": (["--ff"], ckpt_ff)}, smi)
    with Phase("validate --ff --fast_render MC"):
        st["validate --ff --fast_render MC"] = fast_render_batched_phase(
            torch, V, val_dir, ckpt_ff, keep_ff, smi)
    keep31 = str(Path(root) / "kept_fast_render_sequential")
    with Phase("sequential MC --fast_render"):
        st["sequential MC --fast_render"] = fast_render_sequential_phase(
            torch, V, val_dir, ckpt_unfused, keep_seq, keep31, smi)
    st["replay"] = replay_phase(torch, V, val_dir, ckpt_unfused,
                                keep_seq or keep31, smi)
    return st


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke runs on a CUDA card only")
    sys.path.insert(0, str(ROOT))
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch.models.renderer import (
        render_frame_fast)
    from nerfsafetyvalidation_tpu_torch.ops.freq_encoding import freq_encode
    from nerfsafetyvalidation_tpu_torch.models import make_network
    from nerfsafetyvalidation_tpu_torch.ops.hopper import (fold_build,
                                                           fused_mlp,
                                                           gather,
                                                           points_mlp,
                                                           sigma_color)
    from nerfsafetyvalidation_tpu_torch.scripts import (bench_gather,
                                                        k7_variants)
    from nerfsafetyvalidation_tpu_torch.ops.mip_encoding import (
        materialize_dense)
    from nerfsafetyvalidation_tpu_torch.train.trainer import Trainer
    from nerfsafetyvalidation_tpu_torch import bench, main_nerf
    from nerfsafetyvalidation_tpu_torch.models.network_ff import (
        NeRFNetworkFF)
    from nerfsafetyvalidation_tpu_torch.data.png import read_png
    from nerfsafetyvalidation_tpu_torch.data.synthetic import write_dataset
    from nerfsafetyvalidation_tpu_torch.ops.sh_encoding import sh_encode
    from nerfsafetyvalidation_tpu_torch import bench_rollouts
    from nerfsafetyvalidation_tpu_torch.models.renderer import (
        render_frame_guided)
    from nerfsafetyvalidation_tpu_torch.validation.utils.sdf import build_sdf
    from nerfsafetyvalidation_tpu_torch import validate as validate_cli

    # float32 products in full float32 (the plain versions' sums, and K2
    # f32's library chain)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # one nvcc build per source; the launch count of each kernel
    builds = {"K1, K2": points_mlp, "K3": sigma_color, "K4": fused_mlp,
              "K5": fold_build, "K6, K7": gather,
              "K7 variants": k7_variants}
    counters = {"K1 f32": (points_mlp, "LAUNCHES_F32"),
                "K2": (points_mlp, "LAUNCHES_DEEP"),
                "K3": (sigma_color, "LAUNCHES"),
                "K3 f32": (sigma_color, "LAUNCHES_F32"),
                "K4": (fused_mlp, "LAUNCHES"),
                "K4 f32": (fused_mlp, "LAUNCHES_F32"),
                "K5": (fold_build, "LAUNCHES"),
                "K5 bwd": (fold_build, "LAUNCHES_BWD"),
                "K6": (gather, "LAUNCHES_VMEM"),
                "K7": (gather, "LAUNCHES_DMA")}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        points_mlp.LAUNCHES_BY_WIDTH.clear()

    def counts():
        return {"K1": sum(points_mlp.LAUNCHES_BY_WIDTH.values()),
                **{k: getattr(mod, attr)
                   for k, (mod, attr) in counters.items()}}

    def plain_calls():
        """Calls of the plain versions of K1/K2, K3 and K4 so far, as each
        plain function counts them."""
        return {"K1, K2": points_mlp.PLAIN_CALLS,
                "K3": sigma_color.PLAIN_CALLS, "K4": fused_mlp.PLAIN_CALLS}

    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}")

    with Phase("build"):
        def timed_build(mod):
            t0 = time.perf_counter()
            lib = mod.build()
            return lib, time.perf_counter() - t0

        with ThreadPoolExecutor(len(builds)) as pool:
            built = dict(zip(builds, pool.map(timed_build,
                                              builds.values())))
        for name, (lib, secs) in built.items():
            print(f"{name} built in {secs:.2f} s: {lib.relative_to(ROOT)}")
            log = builds[name].BUILD_LOG.splitlines()
            for line in log:
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line or "warning" in line
                        or "Performance Loss" in line):
                    print("  ptxas:", line.strip())
            if name in ("K1, K2", "K3", "K4") and log:
                # the wgmma kernels, where this run built them: no spills,
                # and no product serialised by ptxas
                spills = [ln for ln in log if "spill stores" in ln]
                check(spills and all("0 bytes spill stores, 0 bytes spill "
                                     "loads" in ln for ln in spills)
                      and not any("Performance Loss" in ln for ln in log),
                      f"ptxas spills or serialises a {name} kernel")

    RES = F.RES

    def psnr(img, gt, name):
        """PSNR of a frame [RES^2, 3] against the ground truth."""
        check(img.shape == (RES * RES, 3)
              and bool(torch.isfinite(img).all()),
              f"{name} image is not finite [N, 3]")
        pred = img.cpu().numpy().reshape(RES, RES, 3).astype(np.float64)
        return float(-10.0 * np.log10(max(np.mean((pred - gt) ** 2),
                                           1e-10)))

    with Phase("teacher"), torch.inference_mode():
        t0 = time.perf_counter()
        teacher, stored = F.load_teacher_net(dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        teacher.to_folded()               # timed alone: the fold again
        torch.cuda.synchronize()
        t_fold = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = F.refresh(teacher, stored)
        torch.cuda.synchronize()
        t_refresh = time.perf_counter() - t0
        n_bits = 8 * state.density_bitfield.numel()
        flipped = popcount(torch, state.density_bitfield
                           ^ stored.density_bitfield)
        occupied = popcount(torch, state.density_bitfield)
        print(f"teacher: load and fold {t_load:.2f} s, fold alone "
              f"{t_fold:.3f} s (table {tuple(teacher.fold_table.shape)} "
              f"{teacher.fold_table.dtype}), {F.REFRESHES} refreshes "
              f"{t_refresh:.3f} s; mean_density stored "
              f"{float(stored.mean_density):.4f} -> "
              f"{float(state.mean_density):.4f}; iter_density "
              f"{int(state.iter_density)}; occupied cells {occupied} of "
              f"{n_bits}; bits differing from the stored bitfield "
              f"{flipped}")
        check(int(state.iter_density) == int(stored.iter_density)
              + F.REFRESHES, "the refresh count")
        check(0 < occupied < n_bits, "the refreshed grid is empty or full")

    with Phase("kernel K5"), torch.inference_mode():
        # the teacher's own pyramid, materialised and folded at F = 128
        spec = teacher.mip_spec
        Fk, Cd = spec.F, spec.dense_channels
        k5 = {}
        # fold row (x, y, z), corner k -> its dV row, for the library call
        ar = torch.arange(Fk, device=dev)
        bits = torch.tensor(fold_build._BITS, device=dev)
        idx = (((ar[:, None, None, None] + bits[:, 0]) * (Fk + 1)
                + ar[None, :, None, None] + bits[:, 1]) * (Fk + 1)
               + ar[None, None, :, None] + bits[:, 2]).reshape(-1)
        for dt in (torch.bfloat16, torch.float32):
            V = materialize_dense({"pyramid": list(teacher.pyramid)}, spec,
                                  dtype=dt).contiguous()
            gct = torch.Generator(device=dev).manual_seed(5)
            ct = torch.randn((Fk ** 3, 8 * Cd), generator=gct, device=dev,
                             dtype=dt)
            got = fold_build.fold_build_forward(V, Fk, Cd)
            got_b = fold_build.fold_build_backward(ct, Fk, Cd)
            torch.cuda.synchronize()
            want = fold_build.fold_build_plain(V, Fk, Cd)
            want_b = fold_build.fold_build_bwd_plain(ct, Fk, Cd)
            err = float((got.float() - want.float()).abs().max())
            err_b = float((got_b.float() - want_b.float()).abs().max())
            print(f"K5 {dt}: V {tuple(V.shape)}, fold {tuple(got.shape)}; "
                  f"forward vs plain max abs {err:.3e}, equal "
                  f"{torch.equal(got, want)}; backward vs plain max abs "
                  f"{err_b:.3e}, equal {torch.equal(got_b, want_b)} (dV "
                  f"up to {float(want_b.float().abs().max()):.3e})")
            check(torch.equal(got, want),
                  f"K5 forward ({dt}) is not bit-exact against the plain "
                  "slice-stack")
            check(torch.equal(got_b, want_b),
                  f"K5 backward ({dt}) is not bit-exact against its plain "
                  "version")
            # one read of the input and one write of the output, each way
            nbytes = (V.numel() + got.numel()) * V.element_size()
            bound, by = bound_ms(0.0, nbytes)
            ms = cuda_ms(torch, lambda: fold_build.fold_build_forward(
                V, Fk, Cd), 20)
            ms_b = cuda_ms(torch, lambda: fold_build.fold_build_backward(
                ct, Fk, Cd), 20)
            plain = cuda_ms(torch, lambda: fold_build.fold_build_plain(
                V, Fk, Cd), 10)
            plain_b = cuda_ms(torch, lambda: fold_build.fold_build_bwd_plain(
                ct, Fk, Cd), 5)
            # the backward's library call: one index_add_ of the cotangent's
            # [F^3 * 8, Cd] rows into a zeroed dV at each row's corner, the
            # index built outside the timed call (it sums in its own order,
            # so it is held to the kernel within bf16 / f32 rounding)
            def lib_fold_bwd():
                return torch.zeros(((Fk + 1) ** 3, Cd), dtype=dt,
                                   device=dev).index_add_(
                                       0, idx, ct.view(-1, Cd))
            lib_b = cuda_ms(torch, lib_fold_bwd, 20)
            got_l = lib_fold_bwd()
            err_l = float((got_l.float() - got_b.float()).abs().max())
            print(f"K5 {dt} at F={Fk}, Cd={Cd} ({nbytes / 1e6:.1f} MB each "
                  f"way): forward kernel_ms {ms:.4f}, plain_ms (= library_ms"
                  f", one torch.stack) {plain:.4f}; backward kernel_ms "
                  f"{ms_b:.4f}, plain_ms {plain_b:.4f}, library_ms (one "
                  f"index_add_) {lib_b:.4f}, library vs kernel max abs "
                  f"{err_l:.3e}; bound_ms {bound:.4f} ({by}); {smi}")
            check(err_l <= TOL_K5_LIB[str(dt)] * float(
                      want_b.float().abs().max()),
                  f"the library's fold backward ({dt}) does not compute "
                  "K5's function")
            k5[dt] = dict(err=max(err, err_b), ms=ms, ms_b=ms_b, plain=plain,
                          plain_b=plain_b, lib_b=lib_b, bound=bound, by=by)
            del V, ct, got, got_b, want, want_b, got_l
        del idx
        torch.cuda.empty_cache()

    student = F.load_student_net(dev)
    nets = {"teacher": teacher, "student_h160": student}
    scfg = student.cfg
    sn, cn = list(student.sigma_net), list(student.color_net)
    bf = torch.bfloat16

    with Phase("kernel K1"), torch.inference_mode():
        x, d = k1_pts = k1_points(torch, scfg, dev)
        sh = sh_encode(d).to(bf).contiguous()

        def k1():
            return points_mlp.fused_points_sigma_color(x, sh, sn, cn, 12)

        def k1_plain():
            return points_mlp.fused_points_sigma_color_plain(x, sh, sn, cn,
                                                             12)

        sn_bf = [w.to(bf) for w in sn]
        cn_bf = [w.to(bf) for w in cn]

        def library_chain(h, sn_bf=sn_bf, cn_bf=cn_bf, sh=sh):
            # the student's chain from a bf16 encoding as bf16
            # torch.matmul calls (a yardstick only; the student's weights
            # bound here, as later phases reuse the names)
            for i, w in enumerate(sn_bf):
                h = h @ w
                if i != len(sn_bf) - 1:
                    h = torch.relu(h)
            sigma = torch.exp(torch.clamp(h[:, 0].float(), -15.0, 15.0))
            g = torch.cat([sh, h[:, 1:]], dim=-1)
            for i, w in enumerate(cn_bf):
                g = g @ w
                if i != len(cn_bf) - 1:
                    g = torch.relu(g)
            return sigma, torch.sigmoid(g[:, :3].float())

        def k1_library():
            return library_chain(freq_encode(x, 12).to(bf))

        got = k1()
        torch.cuda.synchronize()
        k1_err = compare(torch, "K1", got, k1_plain(), TOL_K1)
        macs = sum(w.shape[0] * w.shape[1] for w in sn + cn)
        k1_bound, k1_by = bound_ms(
            2.0 * K1_ROWS * macs,
            K1_ROWS * (3 * 4 + 16 * 2 + 8 * 4)
            + 2 * sum(w.numel() for w in sn + cn))
        k1_ms = cuda_ms(torch, k1, 50)
        k1_plain_ms = cuda_ms(torch, k1_plain, 10)
        k1_lib_ms = cuda_ms(torch, k1_library, 20)
        print(f"K1 at {K1_ROWS} rows ({macs} MAC/row): kernel_ms "
              f"{k1_ms:.4f}, plain_ms {k1_plain_ms:.4f}, library_ms "
              f"{k1_lib_ms:.4f}, bound_ms {k1_bound:.4f} ({k1_by}); {smi}")
        k1_out = got
        k1_shapes = [dict(hidden=160, rows=K1_ROWS, ms=k1_ms,
                          plain_ms=k1_plain_ms, library_ms=k1_lib_ms,
                          bound_ms=k1_bound, bound_by=k1_by,
                          max_abs_err=k1_err)]

        # the bench's other students (bench_student_h192x6.pkl and the
        # 256-wide bench_student.pkl) on the same rows: the shapes of their
        # K=16 tiles in the baked_h192 and baked frames
        for hid in (192, 256):
            s_net = F.load_student_net(dev, "spheres", hid)
            sn_h, cn_h = list(s_net.sigma_net), list(s_net.color_net)

            def k1_h(sn_h=sn_h, cn_h=cn_h):
                return points_mlp.fused_points_sigma_color(x, sh, sn_h,
                                                           cn_h, 12)

            def k1_h_plain(sn_h=sn_h, cn_h=cn_h):
                return points_mlp.fused_points_sigma_color_plain(
                    x, sh, sn_h, cn_h, 12)

            sn_hb = [w.to(bf) for w in sn_h]
            cn_hb = [w.to(bf) for w in cn_h]

            def k1_h_library(sn_hb=sn_hb, cn_hb=cn_hb):
                return library_chain(freq_encode(x, 12).to(bf), sn_hb, cn_hb)

            got_h = k1_h()
            torch.cuda.synchronize()
            err_h = compare(torch, f"K1 H={hid} (committed student)", got_h,
                            k1_h_plain(), TOL_K1)
            macs_h = sum(w.shape[0] * w.shape[1] for w in sn_h + cn_h)
            bound_h, by_h = bound_ms(
                2.0 * K1_ROWS * macs_h,
                K1_ROWS * (3 * 4 + 16 * 2 + 8 * 4)
                + 2 * sum(w.numel() for w in sn_h + cn_h))
            ms_h = cuda_ms(torch, k1_h, 50)
            plain_h = cuda_ms(torch, k1_h_plain, 10)
            lib_h = cuda_ms(torch, k1_h_library, 20)
            print(f"K1 H={hid} at {K1_ROWS} rows ({macs_h} MAC/row): "
                  f"kernel_ms {ms_h:.4f}, plain_ms {plain_h:.4f}, "
                  f"library_ms {lib_h:.4f}, bound_ms {bound_h:.4f} "
                  f"({by_h}); {smi}")
            k1_shapes.append(dict(hidden=hid, rows=K1_ROWS, ms=ms_h,
                                  plain_ms=plain_h, library_ms=lib_h,
                                  bound_ms=bound_h, bound_by=by_h,
                                  max_abs_err=err_h))
            k1_err = max(k1_err, err_h)
            del s_net, sn_h, cn_h, sn_hb, cn_hb, got_h

        # the kernel's other widths (another ring and k-chunking each):
        # seeded weights of the student's shapes, points in the box,
        # unit directions' SH stand-ins
        gw = torch.Generator(device=dev).manual_seed(3)
        for hid, rows in K1_WIDTHS:
            def seeded(i, o):
                return torch.randn((i, o), generator=gw, device=dev) * (
                    2.0 / i) ** 0.5
            sn_w = [seeded(75, hid)] + [seeded(hid, hid)
                                        for _ in range(len(sn) - 2)] + [
                seeded(hid, 16)]
            cn_w = [seeded(31, 64)] + [seeded(64, 64)
                                       for _ in range(len(cn) - 2)] + [
                seeded(64, 3)]
            x_w = (torch.rand((rows, 3), generator=gw, device=dev) * 2
                   - 1).contiguous()
            d_w = torch.randn((rows, 16), generator=gw, device=dev)
            sh_w = (d_w / d_w.norm(dim=-1, keepdim=True)).to(bf) \
                .contiguous()
            got_w = points_mlp.fused_points_sigma_color(x_w, sh_w, sn_w,
                                                        cn_w, 12)
            torch.cuda.synchronize()
            compare(torch, f"K1 H={hid}", got_w,
                    points_mlp.fused_points_sigma_color_plain(
                        x_w, sh_w, sn_w, cn_w, 12), TOL_K1)
        del sn_w, cn_w, x_w, sh_w, got_w

    with Phase("kernel K2"):
        # the K1 rows' frequency encoding [N, 75] through the encoding-in
        # kernel, in bf16 (the input cast before the timed calls) and f32
        with torch.inference_mode():
            enc = freq_encode(x, 12)
            enc_bf, sh32 = enc.to(bf).contiguous(), sh.float().contiguous()

            def k2():
                return points_mlp.fused_sigma_color_deep(enc_bf, sh, sn, cn)

            def k2_plain():
                return points_mlp.fused_sigma_color_deep_plain(enc_bf, sh,
                                                               sn, cn)

            def k2_f32():
                return points_mlp.fused_sigma_color_deep(
                    enc, sh32, sn, cn, compute_dtype=torch.float32)

            def k2_f32_plain():
                return points_mlp.fused_sigma_color_deep_plain(
                    enc, sh32, sn, cn, compute_dtype=torch.float32)

            def k2_library():
                return library_chain(enc_bf)

            sn32, cn32 = [w.float() for w in sn], [w.float() for w in cn]

            def k2_library_f32():
                # the same chain as f32 torch.matmul calls, TF32 off
                return library_chain(enc, sn32, cn32, sh32)

            got = k2()
            got32 = k2_f32()
            torch.cuda.synchronize()
            k2_err = compare(torch, "K2 bf16", got, k2_plain(), TOL_K1)
            compare(torch, "K2 f32", got32, k2_f32_plain(), TOL_K2_F32)
            rel = (got[0] - k1_out[0]).abs() / k1_out[0].abs().clamp(min=1.0)
            print(f"K2 bf16 vs K1 on the same rows (K1 encodes in the "
                  f"kernel): rgb max abs "
                  f"{float((got[1] - k1_out[1]).abs().max()):.3e}, sigma "
                  f"max rel {float(rel.max()):.3e}; K2 f32 vs K2 bf16: rgb "
                  f"max abs {float((got32[1] - got[1]).abs().max()):.3e}")

        # K2's path: one forward and backward of a loss through K2 on the
        # student's rows, every count at 0 before and read after; then the
        # same loss through the plain chain under autograd
        g2 = torch.Generator(device=dev).manual_seed(2)
        sh_g = sh.clone()     # an inference tensor cannot be saved for grad
        r_s = torch.randn(K1_ROWS, generator=g2, device=dev)
        r_c = torch.randn((K1_ROWS, 3), generator=g2, device=dev)

        def k2_grads(fn):
            leaves = [enc_bf.clone().requires_grad_()] + [
                w.detach().clone().requires_grad_() for w in sn + cn]
            s_, c_ = fn(leaves[0], sh_g, leaves[1:1 + len(sn)],
                        leaves[1 + len(sn):])
            loss = (s_ * r_s).sum() + (c_ * r_c).sum()
            return torch.autograd.grad(loss, leaves)

        reset_counts()
        g_k2 = k2_grads(points_mlp.fused_sigma_color_deep)
        torch.cuda.synchronize()
        k2_launches = counts()["K2"]
        g_plain = k2_grads(points_mlp.fused_sigma_color_deep_plain)
        same = [torch.equal(a, b) for a, b in zip(g_k2, g_plain)]
        print(f"K2 path (forward + backward, bf16): K2 launches "
              f"{k2_launches}; gradients (enc, sigma net, color net) equal "
              f"to the plain chain's: {same}; |d enc| up to "
              f"{float(g_k2[0].float().abs().max()):.3e}")
        check(k2_launches == 1, f"K2's path launched K2 {k2_launches} times")
        check(all(same), "K2's gradients differ from the plain chain's")

        macs2 = sum(w.shape[0] * w.shape[1] for w in sn + cn)
        k2_bound, k2_by = bound_ms(
            2.0 * K1_ROWS * macs2,
            K1_ROWS * (75 * 2 + 16 * 2 + 4 * 4)
            + 2 * sum(w.numel() for w in sn + cn))
        # f32: the 3xTF32 route's bound (three tf32 products a
        # multiply-add), and the FFMA bound (67 TFLOP/s f32)
        k2_bytes32 = K1_ROWS * (75 * 4 + 16 * 4 + 4 * 4) \
            + 4 * sum(w.numel() for w in sn + cn)
        k2_bound32, k2_by32 = bound_ms(3 * 2.0 * K1_ROWS * macs2, k2_bytes32,
                                       PEAK_TF32_FLOPS)
        k2_bound32_ffma = bound_ms(2.0 * K1_ROWS * macs2, k2_bytes32,
                                   PEAK_F32_FLOPS)[0]
        with torch.inference_mode():
            k2_ms = cuda_ms(torch, k2, 50)
            k2_plain_ms = cuda_ms(torch, k2_plain, 10)
            k2_lib_ms = cuda_ms(torch, k2_library, 20)
            k2_ms32 = cuda_ms(torch, k2_f32, 10)
            k2_plain_ms32 = cuda_ms(torch, k2_f32_plain, 10)
            k2_lib_ms32 = cuda_ms(torch, k2_library_f32, 10)
            got_l = k2_library_f32()
            check(float((got_l[1] - got32[1]).abs().max()) <= TOL_K2_F32[
                      "rgb"][0], "the f32 library chain does not compute "
                  "K2's function")
        print(f"K2 bf16 at {K1_ROWS} rows ({macs2} MAC/row): kernel_ms "
              f"{k2_ms:.4f}, plain_ms {k2_plain_ms:.4f}, library_ms "
              f"{k2_lib_ms:.4f}, bound_ms {k2_bound:.4f} ({k2_by}); f32: "
              f"kernel_ms {k2_ms32:.4f}, plain_ms {k2_plain_ms32:.4f}, "
              f"library_ms {k2_lib_ms32:.4f} (f32 torch.matmul, TF32 "
              f"{torch.backends.cuda.matmul.allow_tf32}), bound_ms "
              f"{k2_bound32:.4f} ({k2_by32}, three TF32 products at 495 "
              f"TFLOP/s; {100 * k2_bound32 / k2_ms32:.0f}%), FFMA bound "
              f"{k2_bound32_ffma:.4f} (67 TFLOP/s f32; "
              f"{100 * k2_bound32_ffma / k2_ms32:.0f}%); {smi}")
        del enc, enc_bf, sh32, g_k2, g_plain, sn32, cn32, got_l

    views = spheres_views(dev)

    with Phase("kernel K3"), torch.inference_mode():
        k3_pts = k3_points(torch, teacher, state, views)
        enc = teacher.encode_pos(k3_pts["guided"][0]).contiguous()
        sh3 = sh_encode(k3_pts["guided"][1]).to(bf).contiguous()
        rows = enc.shape[0]
        print(f"K3 tile: {rows} rows, {k3_pts['hit']} of {K3_RAYS} rays "
              f"hit; enc {tuple(enc.shape)} {enc.dtype}")
        tsn, tcn = list(teacher.sigma_net), list(teacher.color_net)

        def k3():
            return sigma_color.fused_sigma_color(enc, sh3, tsn, tcn)

        def k3_plain():
            return sigma_color.fused_sigma_color_plain(enc, sh3, tsn, tcn)

        w1, w2, c1s, c1g, c2, c3 = sigma_color._prepare(tsn, tcn)["mats"]

        def k3_library():
            # the same six products as bf16 torch.matmul calls
            h = torch.relu(enc @ w1)
            s = h @ w2
            sigma = torch.exp(torch.clamp(s[:, 0].float(), -15.0, 15.0))
            g = torch.relu(sh3 @ c1s + s @ c1g)
            g = torch.relu(g @ c2)
            return sigma, torch.sigmoid((g @ c3)[:, :3].float())

        def k3_plain_f64():
            # the plain chain with f64 sums: the spread that the sums'
            # order and precision alone make
            def dot(a, w):
                return a.to(bf).double() @ w.to(bf).double()
            h = torch.relu(dot(enc, tsn[0]))
            s = dot(h, tsn[1])
            sigma = torch.exp(torch.clamp(s[:, 0], -15.0, 15.0))
            g = torch.relu(dot(torch.cat([sh3, s[:, 1:].to(bf)], -1),
                               tcn[0]))
            g = torch.relu(dot(g, tcn[1]))
            return sigma.float(), torch.sigmoid(dot(g, tcn[2])).float()

        got = k3()
        torch.cuda.synchronize()
        want = k3_plain()
        k3_err = compare(torch, "K3", got, want, TOL_K3)
        s64, c64 = k3_plain_f64()
        print(f"K3 plain f32 vs f64 sums: rgb max abs "
              f"{float((want[1] - c64).abs().max()):.3e} mean "
              f"{float((want[1] - c64).abs().mean()):.3e}; sigma max rel "
              f"{float(((want[0] - s64).abs() / s64.abs().clamp(min=1.0)).max()):.3e}")
        # the function's own products, W1, W2, C1 (31 rows), C2 and C3 (3
        # columns): not the padded mats of the kernel's layout
        macs3 = sum(w.numel() for w in tsn + tcn)
        k3_bound, k3_by = bound_ms(
            2.0 * rows * macs3, rows * (32 * 2 + 16 * 2 + 4 * 4) + 2 * macs3)
        k3_ms = cuda_ms(torch, k3, 50)
        k3_plain_ms = cuda_ms(torch, k3_plain, 10)
        k3_lib_ms = cuda_ms(torch, k3_library, 20)
        k3_in = rows * (32 * 2 + 16 * 2)

        def k3_copy():
            # the phase's current enc and sh3, copied
            e, s_ = enc.clone(), sh3.clone()
            return lambda: sigma_color.fused_sigma_color(e, s_, tsn, tcn)
        k3_cold, k3_copies = cold_ms(torch, k3_copy, k3_in, 60)
        tile_rows, per_sm, smem3 = sigma_color.launch_plan()
        print(f"K3 launch: {tile_rows} rows a tile, {per_sm} blocks per SM, "
              f"{smem3} bytes of shared memory a block")
        print(f"K3 at {rows} rows ({macs3} MAC/row): kernel_ms "
              f"{k3_ms:.4f} (warm: back to back, inputs in L2; the kernel "
              f"table's figure), cold {k3_cold:.4f} ({k3_copies} copies of "
              f"{k3_in / 1e6:.1f} MB of inputs in turn), plain_ms "
              f"{k3_plain_ms:.4f}, library_ms {k3_lib_ms:.4f}, bound_ms "
              f"{k3_bound:.4f} ({k3_by}); {smi}")
        k3_shapes = [dict(rows=rows, ms=k3_ms, ms_cold=k3_cold,
                          plain_ms=k3_plain_ms, library_ms=k3_lib_ms,
                          bound_ms=k3_bound, bound_by=k3_by,
                          max_abs_err=k3_err)]
        del enc, sh3, got, want, s64, c64

        # one fast tile of pose 0: the samples the marched frame hands the
        # teacher in its first K=16 tile, encoded as the teacher encodes them
        xyz, dirs = k3_pts["fast"]
        enc = teacher.encode_pos(xyz).reshape(xyz.shape[0], -1).contiguous()
        sh3 = teacher.encode_dir(dirs).reshape(enc.shape[0], -1).to(bf) \
            .contiguous()
        rows2 = enc.shape[0]
        got = k3()
        torch.cuda.synchronize()
        want = k3_plain()
        err2 = compare(torch, "K3 fast tile", got, want, TOL_K3)
        k3_err = max(k3_err, err2)
        same = reruns_equal(torch, k3, got)
        print(f"K3 fast tile: {same} of {RERUNS} reruns bit-identical to the "
              f"first")
        check(same == RERUNS, "K3 gives other values on a rerun of the same "
              "rows")
        bound2, by2 = bound_ms(
            2.0 * rows2 * macs3, rows2 * (32 * 2 + 16 * 2 + 4 * 4) + 2 * macs3)
        ms2 = cuda_ms(torch, k3, 20)
        plain2 = cuda_ms(torch, k3_plain, 5)
        lib2 = cuda_ms(torch, k3_library, 10)
        in2 = rows2 * (32 * 2 + 16 * 2)
        cold2, copies2 = cold_ms(torch, k3_copy, in2, 20)
        print(f"K3 at {rows2} rows (fast tile): kernel_ms {ms2:.4f} (warm), "
              f"cold {cold2:.4f} ({copies2} copies of {in2 / 1e6:.1f} MB in "
              f"turn), plain_ms {plain2:.4f}, library_ms {lib2:.4f}, "
              f"bound_ms {bound2:.4f} ({by2}); {smi}")
        k3_shapes.append(dict(rows=rows2, ms=ms2, ms_cold=cold2,
                              plain_ms=plain2, library_ms=lib2,
                              bound_ms=bound2, bound_by=by2, max_abs_err=err2))
        del enc, sh3, got, want, xyz, dirs
        torch.cuda.empty_cache()

    def run_mode(name, n_buckets, nets, state, views):
        """Renders the views twice (first pass, steady pass) with every
        count at 0 before and read after; checks PSNR against the bar and
        the BENCH_r05 band; renders pose 0 again through the plain version
        and compares. Returns (the launches of the mode's kernel, pose 0's
        frame)."""
        kernel = F.MODES[name]["kernel"]

        def render(o, d, plain_field=False):
            return F.render(name, nets, state, o, d,
                            plain_field=plain_field)

        reset_counts()
        first = []
        t0 = time.perf_counter()
        for o, d, _ in views:
            first.append(render(o, d))
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for o, d, _ in views:
            render(o, d)
        torch.cuda.synchronize()
        t_steady = time.perf_counter() - t0
        n_launch = counts()
        check(n_launch[kernel] > 0, f"{name} never launched {kernel}")
        psnrs = [psnr(out["image"], gt, name)
                 for out, (_, _, gt) in zip(first, views)]
        mean, low = float(np.mean(psnrs)), float(np.min(psnrs))
        mode_psnr[name] = mean
        ref_mean, ref_min = BENCH_R05[name]
        buckets = [np.bincount(o["tile_bucket"], minlength=n_buckets)
                   .tolist() for o in first]
        n_frames = 2 * len(views)
        bar = PSNR_BAR if name in BARRED else None
        print(f"{name}: PSNR per pose {[round(p, 3) for p in psnrs]}, mean "
              f"{mean:.3f} min {low:.3f} dB (bar {bar}); BENCH_r05 "
              f"{ref_mean}/{ref_min}, gap {mean - ref_mean:+.3f}/"
              f"{low - ref_min:+.3f} dB (band {GAP_BAND})")
        print(f"{name}: tile buckets per pose {buckets}; launches in "
              f"{n_frames} frames {n_launch}")
        if first[0].get("march") is not None:
            print(f"{name}: march per pose (phase-1 iterations, rays "
                  f"unfinished after them, phase-2 iterations): "
                  f"{[o['march'] for o in first]}")
        print(f"{name}: first pass {t_first:.3f} s, steady pass "
              f"{t_steady:.3f} s for {len(views)} frames = "
              f"{t_steady / len(views):.4f} s/frame, "
              f"{len(views) * RES * RES / t_steady:.0f} rays/s on {smi}")
        if bar is not None:
            check(mean >= bar, f"{name} mean PSNR {mean:.3f} dB under {bar}")
        check(abs(mean - ref_mean) <= GAP_BAND
              and abs(low - ref_min) <= GAP_BAND,
              f"{name} PSNR {mean:.3f}/{low:.3f} dB is more than {GAP_BAND}"
              f" dB from BENCH_r05's {ref_mean}/{ref_min}")
        plain = render(views[0][0], views[0][1], plain_field=True)
        check(counts()[kernel] == n_launch[kernel],
              f"the plain {name} frame launched {kernel}")
        check(bool((plain["tile_bucket"] == first[0]["tile_bucket"]).all()),
              f"the plain {name} frame chose other tile buckets")
        err = (plain["image"] - first[0]["image"]).abs()
        print(f"{name}: pose 0 kernel frame vs plain frame: image max abs "
              f"{float(err.max()):.3e}, mean {float(err.mean()):.3e}")
        check(float(err.max()) <= TOL_IMG_MAX
              and float(err.mean()) <= TOL_IMG_MEAN,
              f"{name} kernel frame disagrees with the plain frame "
              f"(tolerance max {TOL_IMG_MAX}, mean {TOL_IMG_MEAN})")
        return n_launch[kernel], first[0]

    launches = {"K1": 0, "K3": 0, "K4": 0}
    mode_psnr = {}          # each mode's mean PSNR (phase 34's bf16 frames)
    for name, n_buckets in (("fast", 4), ("guided", 3),
                            ("baked_h160_ak8", 3)):
        with Phase(name), torch.inference_mode():
            launches[F.MODES[name]["kernel"]] += run_mode(
                name, n_buckets, nets, state, views)[0]

    with Phase("ref net"), torch.inference_mode():
        t0 = time.perf_counter()
        ref_nets, ref_stored = F.load_ref_nets(dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        ref = ref_nets["ref"]
        reset_counts()
        t0 = time.perf_counter()
        ref_state = F.refresh(ref, ref_stored)
        torch.cuda.synchronize()
        t_refresh = time.perf_counter() - t0
        k4_refresh = fused_mlp.LAUNCHES
        n_bits = 8 * ref_state.density_bitfield.numel()
        flipped = popcount(torch, ref_state.density_bitfield
                           ^ ref_stored.density_bitfield)
        occupied = popcount(torch, ref_state.density_bitfield)
        spec = ref.grid_spec
        print(f"ref net: {spec.num_levels} levels x {spec.level_dim} "
              f"channels, table {tuple(ref.embeddings.shape)}, "
              f"{sum(spec.use_hash)} levels hashed; load {t_load:.2f} s, "
              f"{F.REFRESHES} refreshes {t_refresh:.3f} s with {k4_refresh}"
              f" K4 launches; mean_density stored "
              f"{float(ref_stored.mean_density):.4f} -> "
              f"{float(ref_state.mean_density):.4f}; occupied cells "
              f"{occupied} of {n_bits}; bits differing from the stored "
              f"bitfield {flipped}")
        check(int(ref_state.iter_density) == int(ref_stored.iter_density)
              + F.REFRESHES, "the ref net's refresh count")
        check(0 < occupied < n_bits, "the ref net's grid is empty or full")
        check(k4_refresh == F.REFRESHES * ref.cfg.cascade,
              f"the refresh launched K4 {k4_refresh} times")

    with Phase("kernel K4"), torch.inference_mode():
        # one shaded tile of pose 0's marched frame: the samples the
        # renderer hands the net in its first K=16 tile
        seen = []

        class Capture:
            cfg = ref.cfg

            def __call__(self, x, d, plain=False):
                seen.append((x, d))
                return ref(x, d, plain=plain)

        o, d, _ = views[0]
        F.render("ref_backbone", {"ref": Capture()}, ref_state, o, d)
        tiles = [xd for xd in seen if xd[0].shape[0] == K4_RAYS * K4_K]
        check(len(tiles) > 0, "pose 0 has no K=16 tile")
        xyz, dirs = tiles[0]
        rows = xyz.shape[0]
        enc = ref.encode_pos(xyz).contiguous()
        sn, cn = list(ref.sigma_net), list(ref.color_net)
        s_plain = fused_mlp.fused_mlp_plain(enc, sn)
        cin = torch.cat([ref.encode_dir(dirs).to(bf),
                         s_plain[:, 1:].to(bf)], dim=-1).contiguous()
        print(f"K4 tile: {rows} samples; enc {tuple(enc.shape)} "
              f"{enc.dtype}, color input {tuple(cin.shape)} {cin.dtype}")

        def k4():
            return (fused_mlp.fused_mlp(enc, sn),
                    fused_mlp.fused_mlp(cin, cn))

        def k4_plain():
            return (fused_mlp.fused_mlp_plain(enc, sn),
                    fused_mlp.fused_mlp_plain(cin, cn))

        sn_bf = [w.to(bf) for w in sn]
        cn_bf = [w.to(bf) for w in cn]

        def chain_bf16(h, ws):
            for i, w in enumerate(ws):
                h = h @ w
                if i != len(ws) - 1:
                    h = torch.relu(h)
            return h.float()

        def k4_library():
            # the same two chains as bf16 torch.matmul calls
            return chain_bf16(enc, sn_bf), chain_bf16(cin, cn_bf)

        def chain_f64(h, ws):
            # the plain chain with f64 sums: the spread that the sums'
            # order and precision alone make
            for i, w in enumerate(ws):
                h = h.to(bf).double() @ w.to(bf).double()
                if i != len(ws) - 1:
                    h = torch.relu(h)
                h = h.to(bf)
            return h.float()

        got = k4()
        torch.cuda.synchronize()
        want = k4_plain()
        f64 = (chain_f64(enc, sn), chain_f64(cin, cn))
        k4_err = 0.0
        for what, g, w, w64 in zip(("sigma", "color"), got, want, f64):
            check(g.shape == w.shape and bool(torch.isfinite(g).all()),
                  f"K4 {what} output is not finite {tuple(w.shape)}")
            rel = (g - w).abs() / w.abs().clamp(min=1.0)
            rel64 = (w64 - w).abs() / w.abs().clamp(min=1.0)
            k4_err = max(k4_err, float((g - w).abs().max()))
            print(f"K4 {what} net vs plain on {rows} rows: max rel "
                  f"{float(rel.max()):.3e} mean {float(rel.mean()):.3e} "
                  f"(max abs {float((g - w).abs().max()):.3e} at |values| "
                  f"up to {float(w.abs().max()):.3e}); plain f32 vs f64 "
                  f"sums: max rel {float(rel64.max()):.3e} mean "
                  f"{float(rel64.mean()):.3e}")
            t_max, t_mean = TOL_K4[what]
            check(float(rel.max()) <= t_max and float(rel.mean()) <= t_mean,
                  f"K4 {what} net disagrees with the plain version "
                  f"(tolerance max {t_max}, mean {t_mean})")
        same = reruns_equal(torch, k4, got)
        print(f"K4 tile: {same} of {RERUNS} reruns bit-identical to the "
              f"first")
        check(same == RERUNS, "K4 gives other values on a rerun of the same "
              "rows")
        macs4 = sum(w.shape[0] * w.shape[1] for w in sn + cn)
        k4_bound, k4_by = bound_ms(
            2.0 * rows * macs4,
            rows * (32 * 2 + 16 * 4 + 31 * 2 + 3 * 4)
            + 2 * sum(w.numel() for w in sn + cn))
        k4_ms = cuda_ms(torch, k4, 20)
        k4_plain_ms = cuda_ms(torch, k4_plain, 5)
        k4_lib_ms = cuda_ms(torch, k4_library, 10)
        k4_in = rows * (32 * 2 + 31 * 2)

        def k4_copy():
            e, c_ = enc.clone(), cin.clone()
            return lambda: (fused_mlp.fused_mlp(e, sn),
                            fused_mlp.fused_mlp(c_, cn))
        k4_cold, k4_copies = cold_ms(torch, k4_copy, k4_in, 20)
        for what, net in (("sigma", sn), ("color", cn)):
            widths = [net[0].shape[0]] + [w.shape[1] for w in net]
            tile_rows, stages, stage, smem4, per_sm, a_steps = \
                fused_mlp.launch_plan(widths)
            print(f"K4 launch, {what} net {widths}: {tile_rows} rows a "
                  f"tile, {stages} stages of {stage} bytes, {smem4} bytes "
                  f"of shared memory a block, {per_sm} blocks per SM, A "
                  f"fragments for {16 * a_steps} columns")
        print(f"K4 pair at {rows} rows ({macs4} MAC/row): kernel_ms "
              f"{k4_ms:.4f} (warm: back to back; the kernel table's "
              f"figure), cold {k4_cold:.4f} ({k4_copies} copies of "
              f"{k4_in / 1e6:.1f} MB of inputs in turn), plain_ms "
              f"{k4_plain_ms:.4f}, library_ms {k4_lib_ms:.4f}, bound_ms "
              f"{k4_bound:.4f} ({k4_by}); {smi}")
        del seen, tiles, enc, cin, got, want, f64

    pose0 = views[:1]
    for name in ("ref_backbone", "ref_backbone_ml8"):
        with Phase(name), torch.inference_mode():
            n, frame = run_mode(name, 4, ref_nets, ref_state, pose0)
            launches["K4"] += n
            # BENCH_r05 ran this line unfused: plain matmul chains whose
            # last layers stay f32. A check only; it launches no kernel.
            net = ref_nets[F.MODES[name]["net"]]
            unfused = make_network(
                replace(net.cfg, fused=False),
                {"encoder": {"embeddings": net.embeddings},
                 "sigma_net": list(net.sigma_net),
                 "color_net": list(net.color_net)}, device=dev)
            reset_counts()
            o, d, gt = pose0[0]
            out = F.render_frame_fast(unfused, ref_state, o, d,
                                      **F.MODES[name]["frame"])
            check(fused_mlp.LAUNCHES == 0, "the unfused frame launched K4")
            p_unf, p_k4 = psnr(out["image"], gt, name), psnr(
                frame["image"], gt, name)
            if name == "ref_backbone":
                ref_psnr = p_k4
            err = (out["image"] - frame["image"]).abs()
            print(f"{name}: pose 0 unfused (f32 last layers) {p_unf:.3f} dB"
                  f", K4 frame {p_k4:.3f} dB, gap {p_k4 - p_unf:+.3f} dB; "
                  f"BENCH_r05 gap of the unfused frame "
                  f"{p_unf - BENCH_R05[name][0]:+.3f} dB; image max abs "
                  f"{float(err.max()):.3e}, mean {float(err.mean()):.3e}")

    with Phase("kernel K4 f32"), torch.inference_mode():
        # phase 9's shaded tile through the float32 net (REF_CFG_F32):
        # the sigma net on its f32 encoding, the color net on [SH | geo]
        ref32 = ref_nets["ref_f32"]
        sn, cn = list(ref32.sigma_net), list(ref32.color_net)
        f32 = torch.float32
        enc = ref32.encode_pos(xyz).contiguous()
        s_plain = fused_mlp.fused_mlp_plain(enc, sn, f32)
        cin = torch.cat([ref32.encode_dir(dirs), s_plain[:, 1:]],
                        dim=-1).contiguous()
        rows = enc.shape[0]
        print(f"K4 f32 tile: {rows} samples; enc {tuple(enc.shape)} "
              f"{enc.dtype}, color input {tuple(cin.shape)} {cin.dtype}")

        def k4_f32():
            return (fused_mlp.fused_mlp(enc, sn, f32),
                    fused_mlp.fused_mlp(cin, cn, f32))

        def k4_f32_plain():
            return (fused_mlp.fused_mlp_plain(enc, sn, f32),
                    fused_mlp.fused_mlp_plain(cin, cn, f32))

        def chain_f32(h, ws):
            # one f32 torch.matmul a layer, TF32 off
            for i, w in enumerate(ws):
                h = h @ w
                if i != len(ws) - 1:
                    h = torch.relu(h)
            return h

        def k4_f32_library():
            return chain_f32(enc, sn), chain_f32(cin, cn)

        before = counts()["K4 f32"]
        got = k4_f32()
        torch.cuda.synchronize()
        check(counts()["K4 f32"] == before + 2, "the f32 pair did not launch "
              "K4's f32 kernel twice")
        want = k4_f32_plain()
        k4_err32 = 0.0
        for what, g, w in zip(("sigma", "color"), got, want):
            check(g.shape == w.shape and bool(torch.isfinite(g).all()),
                  f"K4 f32 {what} output is not finite {tuple(w.shape)}")
            err = (g - w).abs()
            rel = err / w.abs().clamp(min=1e-30)
            k4_err32 = max(k4_err32, float(err.max()))
            print(f"K4 f32 {what} net vs plain on {rows} rows: max abs "
                  f"{float(err.max()):.3e} (|values| up to "
                  f"{float(w.abs().max()):.3e}), max rel where |plain| > "
                  f"1e-3 {float(rel[w.abs() > 1e-3].max()):.3e}, mean abs "
                  f"{float(err.mean()):.3e}")
            check(torch.allclose(g, w, rtol=TOL_K4_F32[0],
                                 atol=TOL_K4_F32[1]),
                  f"K4 f32 {what} net disagrees with the plain version "
                  f"(rtol {TOL_K4_F32[0]}, atol {TOL_K4_F32[1]})")
        got_l = k4_f32_library()
        check(all(torch.allclose(a, b, rtol=TOL_K4_F32[0],
                                 atol=TOL_K4_F32[1])
                  for a, b in zip(got_l, want)),
              "the f32 library chain does not compute K4's function")
        same = reruns_equal(torch, k4_f32, got)
        print(f"K4 f32 tile: {same} of {RERUNS} reruns bit-identical to "
              f"the first")
        check(same == RERUNS, "K4 f32 gives other values on a rerun of the "
              "same rows")
        macs4 = sum(w.shape[0] * w.shape[1] for w in sn + cn)
        # the route that runs, 3xTF32: three tf32 products a multiply-add
        k4_bound32, k4_by32 = bound_ms(
            3 * 2.0 * rows * macs4,
            rows * 4 * (32 + 16 + 31 + 3)
            + 4 * sum(w.numel() for w in sn + cn), PEAK_TF32_FLOPS)
        # the earlier FFMA route's (f32 on the CUDA cores), for comparison
        k4_bound32_ffma, k4_by32_ffma = bound_ms(
            2.0 * rows * macs4,
            rows * 4 * (32 + 16 + 31 + 3)
            + 4 * sum(w.numel() for w in sn + cn), PEAK_F32_FLOPS)
        k4_ms32 = cuda_ms(torch, k4_f32, 10)
        k4_plain_ms32 = cuda_ms(torch, k4_f32_plain, 5)
        k4_lib_ms32 = cuda_ms(torch, k4_f32_library, 5)
        k4_in32 = rows * 4 * (32 + 31)

        def k4_f32_copy():
            e, c_ = enc.clone(), cin.clone()
            return lambda: (fused_mlp.fused_mlp(e, sn, f32),
                            fused_mlp.fused_mlp(c_, cn, f32))
        k4_cold32, copies32 = cold_ms(torch, k4_f32_copy, k4_in32, 10)
        for what, net in (("sigma", sn), ("color", cn)):
            widths = [net[0].shape[0]] + [w.shape[1] for w in net]
            tile_rows, resident, stages, smem4, per_sm, widest = \
                fused_mlp.launch_plan(widths, f32)
            held = "resident" if resident else "a layer at a time"
            print(f"K4 f32 launch, {what} net {widths}: {tile_rows} rows a "
                  f"tile, tf32 hi/lo weight images {held}, {stages} stages "
                  f"of x, {smem4} bytes of shared memory a block, "
                  f"{per_sm} blocks per SM, the build for widths up to "
                  f"{widest}")
        print(f"K4 f32 pair at {rows} rows ({macs4} MAC/row): kernel_ms "
              f"{k4_ms32:.4f} (warm), cold {k4_cold32:.4f} ({copies32} "
              f"copies of {k4_in32 / 1e6:.1f} MB of inputs in turn), "
              f"plain_ms {k4_plain_ms32:.4f}, library_ms {k4_lib_ms32:.4f} "
              f"(f32 torch.matmul, TF32 "
              f"{torch.backends.cuda.matmul.allow_tf32}), bound_ms "
              f"{k4_bound32:.4f} ({k4_by32}, three tf32 products at 495 "
              f"TFLOP/s), the FFMA route's bound_ms {k4_bound32_ffma:.4f} "
              f"({k4_by32_ffma}, 67 TFLOP/s f32); {smi}")
        gen = torch.Generator(device=dev).manual_seed(19)
        for widths, n_odd in K4_F32_ODD:
            # one row more, so that x[1:] starts off a 16-byte boundary
            # where D_0 is not a multiple of 4 (the wrapper copies such
            # an x)
            x_o = torch.randn((n_odd + 1, widths[0]), generator=gen,
                              device=dev)[1:]
            w_o = [torch.randn((a, b), generator=gen, device=dev) / a ** 0.5
                   for a, b in zip(widths, widths[1:])]
            g_o = fused_mlp.fused_mlp(x_o, w_o, f32)
            p_o = fused_mlp.fused_mlp_plain(x_o, w_o, f32)
            # the wrapper's mirror of the plan (tile rows, weights resident,
            # stages, bytes) against the built kernel's
            plan = fused_mlp.launch_plan(widths, f32)
            mirror = fused_mlp._plan_f32(widths)
            mirror = (fused_mlp._f32_tile_rows(widths),
                      int(mirror["resident"]), mirror["stages"],
                      mirror["total"])
            print(f"K4 f32 at {widths} ({n_odd} rows, weights "
                  f"{'resident' if plan[1] else 'a layer at a time'}, the "
                  f"build for widths up to {plan[5]}): max abs "
                  f"{float((g_o - p_o).abs().max()):.3e} against the plain "
                  f"version; plan {tuple(plan[:4])}, the wrapper's "
                  f"{mirror}")
            check(bool(torch.allclose(g_o, p_o, rtol=TOL_K4_F32[0],
                                      atol=TOL_K4_F32[1])),
                  f"K4 f32 disagrees with the plain version at {widths}")
            check(tuple(plan[:4]) == mirror, f"the wrapper's f32 plan of "
                  f"{widths} is not the kernel's")
        del enc, cin, got, want, got_l, xyz, dirs, s_plain
        torch.cuda.empty_cache()

    staged = {}
    for name in F.STAGED_MODES:
        with Phase(name), torch.inference_mode():
            # the reference backbone observed as the entry points observe a
            # trained NeRF: pose 0 at 800x800 through the staged render at
            # the CLI's defaults, 157 chunks of 4,096 rays x 512 samples
            mode = F.MODES[name]
            kernel = mode["kernel"]
            other = "K4" if kernel == "K4 f32" else "K4 f32"
            o, d, gt = views[0]
            batch = mode["frame"]["max_ray_batch"]
            n_chunks = -(-o.shape[0] // batch)
            t0 = time.perf_counter()
            F.render(name, ref_nets, None, o[:batch], d[:batch])
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t0
            reset_counts()
            t0 = time.perf_counter()
            out = F.render(name, ref_nets, None, o, d)
            torch.cuda.synchronize()
            t_frame = time.perf_counter() - t0
            n_launch = counts()
            p_frame = psnr(out["image"], gt, name)
            check(bool(torch.isfinite(out["depth"]).all()
                       and torch.isfinite(out["aggregated_density"]).all()),
                  f"{name}: depth or aggregated density not finite")
            print(f"{name}: pose 0 at {RES}x{RES} in {n_chunks} chunks of "
                  f"{batch} rays x {mode['frame']['num_steps']} samples: "
                  f"{t_frame:.3f} s/frame, {RES * RES / t_frame:.0f} rays/s "
                  f"(one chunk first: {t_warm:.3f} s) on {smi}; launches "
                  f"{n_launch}; PSNR {p_frame:.3f} dB (ref_backbone's marched"
                  f" frame: BENCH_r05 {BENCH_R05['ref_backbone'][0]} dB, "
                  f"this run {ref_psnr:.3f} dB)")
            check(n_launch[kernel] == 2 * n_chunks,
                  f"{name} launched {kernel} {n_launch[kernel]} times, not "
                  f"twice in each of {n_chunks} chunks")
            check(n_launch[other] == 0, f"{name} launched {other}")
            # two chunks again through the plain field: a central one and
            # the padded last one (its rgbs and sigmas are the frame's)
            tol = TOL_STAGED[kernel]
            for which, c in (("central", n_chunks // 2),
                             ("last", n_chunks - 1)):
                sl = slice(c * batch, min((c + 1) * batch, o.shape[0]))
                plain = F.render(name, ref_nets, None, o[sl], d[sl],
                                 plain_field=True)
                check(counts()[kernel] == n_launch[kernel],
                      f"the plain {name} chunk launched {kernel}")
                err = (plain["image"] - out["image"][sl]).abs()
                line = (f"{name}: {which} chunk {c} ({sl.stop - sl.start} "
                        f"rays) kernel vs plain field: image max abs "
                        f"{float(err.max()):.3e}, mean "
                        f"{float(err.mean()):.3e}")
                check(float(err.max()) <= tol["image"][0]
                      and float(err.mean()) <= tol["image"][1],
                      f"{name} {which} chunk's image disagrees with the "
                      f"plain field's (tolerance {tol['image']})")
                if which == "last":
                    e_rgb = (plain["rgbs"] - out["rgbs"]).abs()
                    s_p, s_k = plain["sigmas"], out["sigmas"]
                    e_sig = (s_k - s_p).abs() / s_p.abs().clamp(min=1.0)
                    line += (f"; last chunk's rgbs {tuple(out['rgbs'].shape)}"
                             f" max abs {float(e_rgb.max()):.3e}, sigmas "
                             f"{tuple(s_k.shape)} max rel "
                             f"{float(e_sig.max()):.3e}")
                    check(out["rgbs"].shape == (batch,
                                                mode["frame"]["num_steps"],
                                                3)
                          and bool(torch.isfinite(out["rgbs"]).all()
                                   and torch.isfinite(s_k).all()),
                          f"{name}: the last chunk's rgbs / sigmas")
                    check(float(e_rgb.max()) <= tol["rgbs"]
                          and float(e_sig.max()) <= tol["sigma"],
                          f"{name} last chunk's rgbs / sigmas disagree with "
                          f"the plain field's (tolerance {tol})")
                print(line)
            staged[name] = dict(s_frame=t_frame, rays_s=RES * RES / t_frame,
                                psnr=p_frame, launches=n_launch[kernel])
            del out, plain
            torch.cuda.empty_cache()
    launches["K4"] += staged["staged_bf16"]["launches"]

    with Phase("gradients"):
        # outside inference mode, with weights that require grad: K1 and K4
        # return the plain chain's gradients (K3's: phase 34)
        sn1 = [w.detach().clone().requires_grad_()
               for w in student.sigma_net]
        cn1 = [w.detach().clone().requires_grad_()
               for w in student.color_net]
        x1 = x.clone().requires_grad_()

        def k1_grads(fn):
            s_, c_ = fn(x1, sh_g, sn1, cn1, 12)
            return torch.autograd.grad((s_ * r_s).sum() + (c_ * r_c).sum(),
                                       [x1] + sn1 + cn1)

        n1 = counts()["K1"]
        g_k1 = k1_grads(points_mlp.fused_points_sigma_color)
        check(counts()["K1"] == n1 + 1, "K1's gradient call did not "
              "launch K1")
        same = [torch.equal(a, b) for a, b in zip(
            g_k1, k1_grads(points_mlp.fused_points_sigma_color_plain))]
        print(f"K1 with gradients: (x, sigma net, color net) equal to the "
              f"plain chain's: {same}")
        check(all(same), "K1's gradients differ from the plain chain's")
        # K4's backward: the VJP of fused_mlp_reference (the JAX
        # package's _xla_mlp), recomputed; the forward launches the
        # kernel. At a marched training step's rows and a uniform one's,
        # both nets of the ref backbone, and in bf16 also both nets of
        # NeRFNetworkFF (what --ff trains; seeded weights), seeded x and
        # cotangents: the kernel's output must agree with the plain
        # version (TOL_K4 in bf16, TOL_K4_F32 in f32), and the gradients
        # must equal autograd's through the recompute, bit for bit
        g4 = torch.Generator(device=dev).manual_seed(12)
        ff = NeRFNetworkFF(F.REF_CFG, device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(13))
        ref_nets4 = (("sigma", "sigma", ref.sigma_net),
                     ("color", "color", ref.color_net))
        ff_nets4 = (("FF sigma", "sigma", ff.sigma_net),
                    ("FF color", "color", ff.color_net))
        check([[w.shape[0] for w in ws] + [ws[-1].shape[1]]
               for _, _, ws in ff_nets4] == list(FF_WIDTHS),
              "the FF nets are not at the FF widths")
        for dname, dt, key, nets4 in (
                ("bf16", bf, "K4", ref_nets4 + ff_nets4),
                ("f32", torch.float32, "K4 f32", ref_nets4)):
            for rows in K4_GRAD_ROWS:
                for which, role, net_ws in nets4:
                    ws = [w.detach().clone().requires_grad_()
                          for w in net_ws]
                    x4 = torch.randn((rows, ws[0].shape[0]), generator=g4,
                                     device=dev).to(dt).requires_grad_()
                    cot = torch.randn((rows, ws[-1].shape[1]), generator=g4,
                                      device=dev)
                    before = counts()
                    out = fused_mlp.fused_mlp(x4, ws, dt)
                    got = torch.autograd.grad(out, [x4] + ws, cot)
                    after = counts()
                    with torch.no_grad():
                        out = out.float()
                        plain = fused_mlp.fused_mlp_plain(
                            x4.detach(), [w.detach() for w in ws],
                            dt).float()
                    fwd_ok = out.shape == plain.shape and bool(
                        torch.isfinite(out).all())
                    if dt is bf:
                        rel = (out - plain).abs() / plain.abs().clamp(
                            min=1.0)
                        t_max, t_mean = TOL_K4[role]
                        fwd_ok &= (float(rel.max()) <= t_max
                                   and float(rel.mean()) <= t_mean)
                        fwd_txt = (f"max rel {float(rel.max()):.3e} mean "
                                   f"{float(rel.mean()):.3e} (tolerance "
                                   f"{t_max}, {t_mean})")
                        del rel
                    else:
                        fwd_ok &= torch.allclose(out, plain,
                                                 rtol=TOL_K4_F32[0],
                                                 atol=TOL_K4_F32[1])
                        fwd_txt = (f"max abs "
                                   f"{float((out - plain).abs().max()):.3e}"
                                   f" (rtol {TOL_K4_F32[0]}, atol "
                                   f"{TOL_K4_F32[1]})")
                    print(f"K4 {dname} {which} net at {rows} rows, output "
                          f"vs plain: {fwd_txt}")
                    check(fwd_ok, f"K4 {dname} {which} net's output at "
                          f"{rows} rows disagrees with the plain version")
                    want = torch.autograd.grad(
                        fused_mlp.fused_mlp_reference(x4, ws, dt),
                        [x4] + ws, cot)
                    same = [torch.equal(a, b) for a, b in zip(got, want)]
                    finite = all(bool(torch.isfinite(a).all()) for a in got)
                    print(f"K4 {dname} {which} net at {rows} rows with "
                          f"gradients: launched {after[key] - before[key]}"
                          f" time(s); (x, weights) gradients equal to the "
                          f"recompute's: {same}; finite {finite}")
                    check(after[key] == before[key] + 1 and all(
                        after[k] == before[k] for k in after if k != key),
                          f"K4 {dname} with gradients did not launch its "
                          "kernel once")
                    check(all(same) and finite, f"K4 {dname}'s gradients "
                          "differ from the recompute's")
                    del ws, x4, cot, out, plain, got, want
        del ff
        torch.cuda.empty_cache()
        del sn1, cn1, x1, g_k1

    with Phase("train"):
        t0 = time.perf_counter()
        opt = F.train_opt(iters=TRAIN_STEPS, grid_warmup_steps=TRAIN_WARMUP)
        splits = F.train_splits()
        dataset = F.train_dataset(dev, opt=opt, splits=splits)
        print(f"train set: {len(dataset)} views at {dataset.H}x{dataset.W} "
              f"({dataset.images.dtype}) in "
              f"{time.perf_counter() - t0:.2f} s")
        epoch_end = []
        reset_counts()
        t0 = time.perf_counter()
        net, t_state, trainer = F.train_flagship(
            dev, iters=TRAIN_STEPS, opt=opt, dataset=dataset,
            on_epoch=lambda tr: epoch_end.append(time.perf_counter()))
        torch.cuda.synchronize()
        steps = trainer.global_step
        t_train = epoch_end[-1] - t0
        train_launches = (fold_build.LAUNCHES, fold_build.LAUNCHES_BWD)
        others = {k: n for k, n in counts().items()
                  if k not in ("K5", "K5 bwd")}
        losses = np.asarray(trainer.stats["step_loss"])
        first, last = float(losses[:16].mean()), float(losses[-16:].mean())
        print(f"train: {steps} steps in {t_train:.2f} s = "
              f"{t_train / steps:.5f} s/step ({steps / t_train:.3f} steps/s)"
              f" on {smi}; per epoch "
              f"{np.diff([t0] + epoch_end).round(3).tolist()} s; K5 launches"
              f" forward {train_launches[0]}, backward {train_launches[1]}; "
              f"other kernels {others}")
        print(f"train: loss first 16 steps {first:.6f}, last 16 {last:.6f}"
              f" (ratio {last / first:.4f}, bound {LOSS_FALL}); epoch means "
              f"{[round(v, 6) for v in trainer.stats['loss']]}; occupied "
              f"cells after the 4x refresh "
              f"{popcount(torch, t_state.density_bitfield)}")
        check(steps == TRAIN_STEPS, f"trained {steps} steps")
        check(train_launches == (steps, steps),
              f"K5 launched {train_launches} times in {steps} steps, not "
              "once forward and once backward per step")
        check(bool(np.isfinite(losses).all()), "a training loss is not finite")
        check(all(bool(torch.isfinite(w).all()) for w in net.param_list()),
              "a trained parameter is not finite")
        check(last < LOSS_FALL * first,
              f"the loss fell from {first:.6f} to {last:.6f}, not under "
              f"{LOSS_FALL} of it")
        # the trainer's evaluation on the 2 validation views, as the JAX
        # runs score validation (the staged render, 128 uniform steps, no
        # upsampling); a cut schedule, so no bar
        t0 = time.perf_counter()
        trainer.evaluate(F.train_dataset(dev, opt=opt, splits=splits,
                                         type="val").dataloader())
        torch.cuda.synchronize()
        eval_psnr = trainer.stats["results"][-1]
        print(f"train: evaluate after {steps} steps (staged render, "
              f"{opt.num_steps} uniform steps, upsampling "
              f"{opt.upsample_steps}) on the 2 validation views: PSNR "
              f"{eval_psnr:.3f} dB, mean loss "
              f"{trainer.stats['valid_loss'][-1]:.6f}, "
              f"{time.perf_counter() - t0:.2f} s")
        check(np.isfinite(eval_psnr), "the evaluation PSNR is not finite")

        # one step through each fold route, from the trained parameters and
        # state, with the same batch and draws
        g = torch.Generator(device=dev).manual_seed(11)
        batch = dataset.collate([0], g)
        bg = torch.rand((1, batch["rays_o"].shape[1], 3), generator=g,
                        device=dev)
        jit = torch.rand((batch["rays_o"].shape[1],), generator=g,
                         device=dev)
        stepped = []
        for route in ("foldrow_pallas", "foldrow", "foldrow_pallas"):
            twin = make_network(replace(F.TRAIN_CFG, train_gather=route),
                                net.params_tree(), device=dev,
                                trainable=True)
            tr = Trainer(opt, twin, mute=True)
            tr.renderer_state, tr.global_step = t_state, steps
            _, loss = tr.train_step(batch, bg=bg, perturb=jit)
            stepped.append((float(loss), [w.detach().clone() for w in
                                          twin.param_list()],
                            [w.grad.clone() for w in twin.param_list()]))
            del tr, twin
        n_pyr = len(net.mip_spec.pyramid_scales)

        def apart(a, b):
            """Per tensor: gradient max |diff| / max |grad|, updated
            parameters max |diff| and share of entries > 1e-6 apart."""
            rel = [float((x - y).abs().max() / y.abs().max().clamp(
                min=1e-30)) for x, y in zip(a[2], b[2])]
            moved = [float((x - y).abs().max()) for x, y in zip(a[1], b[1])]
            frac = [float(((x - y).abs() > 1e-6).float().mean())
                    for x, y in zip(a[1], b[1])]
            return rel, moved, frac

        for what, (a, b) in (("foldrow_pallas vs foldrow", stepped[:2]),
                             ("foldrow_pallas run twice", stepped[::2])):
            rel, moved, frac = apart(a, b)
            print(f"{what}, one step: loss {a[0]:.8f} / {b[0]:.8f}; "
                  f"gradient max |diff| / max |grad| per tensor "
                  f"{['%.2e' % v for v in rel]}; updated parameters max "
                  f"|diff| {['%.2e' % v for v in moved]}, share of entries "
                  f"apart by > 1e-6 {['%.2e' % v for v in frac]} (pyramid "
                  f"grids, hash table, sigma net, color net)")
        rel, moved, frac = apart(*stepped[:2])
        check(max(apart(*stepped[::2])[0]) == 0.0,
              "one route's gradients differ between two runs")
        check(stepped[0][0] == stepped[1][0], "the two routes' losses "
              "differ (the forward fold is the same copy)")
        check(max(rel[n_pyr:]) == 0.0, "the hash table's or the MLPs' "
              "gradients differ between the routes")
        check(max(rel[:n_pyr]) <= TOL_ROUTE_GRAD,
              f"the pyramid gradients of the two routes differ by more "
              f"than {TOL_ROUTE_GRAD} of their largest")
        check(max(moved) <= 2 * opt.lr * (1 + 1e-5)
              and max(frac) <= TOL_ROUTE_FRAC,
              "the two routes' updates differ by more than the stated "
              "tolerance")
        del stepped, net, trainer, dataset, splits
        torch.cuda.empty_cache()

    with Phase("dataset directory"):
        # the spheres set written through data/png.py, then decoded back
        t0 = time.perf_counter()
        data_root = tempfile.TemporaryDirectory()
        data_dir = str(Path(data_root.name) / "spheres")
        splits = F.train_splits()
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_dataset(data_dir, splits)
        t_write = time.perf_counter() - t0
        files = sorted(Path(data_dir).glob("*.png"))
        t0 = time.perf_counter()
        decoded = {f.stem: read_png(f) for f in files}
        t_read = time.perf_counter() - t0
        exact = all(np.array_equal(
            decoded[f"{split}_{k:03d}"].astype(np.float32) / 255.0, img)
            for split, data in splits.items()
            for k, img in enumerate(data["images"]))
        print(f"dataset directory: {len(files)} RGBA PNGs at "
              f"{F.TRAIN_RES}x{F.TRAIN_RES} (traced in {t_gen:.2f} s), "
              f"written in {t_write:.2f} s, decoded in {t_read:.2f} s "
              f"({1e3 * t_read / len(files):.1f} ms a view); decoded equal"
              f" to the splits: {exact}")
        check(len(files) == 54 and exact, "the dataset directory does not "
              "read back as written")
        del splits, decoded

    main_nerf_stats = {}
    for name, extra, key, other in MAIN_NERF_RUNS:
        with Phase(f"main_nerf {name}"):
            ws_dir = str(Path(data_root.name) / f"ws{len(main_nerf_stats)}")
            marks = []
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            tr = main_nerf.main(
                [data_dir, "--workspace", ws_dir, "--bound", "1", "--scale",
                 "1", "--seed", "0", *extra], device="cuda",
                on_epoch=lambda t: marks.append((counts(),
                                                 time.perf_counter())))
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
            after = counts()
            steps = tr.global_step
            t_steps = sum(tr.epoch_times)
            trained = marks[-1][0]
            losses = tr.stats["loss"]
            # PNG frames, or two mp4s where imageio has an mp4 backend
            frames = sorted(Path(ws_dir, "results").glob("*.png"))
            videos = sorted(Path(ws_dir, "results").glob("*.mp4"))
            print(f"main_nerf {name}: {steps} steps in {len(losses)} "
                  f"epochs, {t_steps:.2f} s of epochs: "
                  f"{t_steps / steps:.5f} s/step; epochs "
                  f"{[round(v, 2) for v in tr.epoch_times]} s; {t_all:.2f} "
                  f"s in all (load, train, checkpoints, evaluate, test); "
                  f"{smi}")
            print(f"main_nerf {name}: {key} launches in training "
                  f"{trained[key]} ({trained[key] / steps:.2f} a step), in "
                  f"all {after[key]}; {other} {after[other]}; epoch mean "
                  f"losses {[round(v, 6) for v in losses]}; test-split "
                  f"evaluate PSNR {tr.stats['results'][-1]:.3f} dB; "
                  f"{len(frames)} PNG frames and {len(videos)} mp4s "
                  f"written; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
            widths = [[ws[0].shape[0]] + [w.shape[1] for w in ws]
                      for ws in (tr.net.sigma_net, tr.net.color_net)]
            print(f"main_nerf {name}: {type(tr.net).__name__}, "
                  f"{tr.net.cfg.compute_dtype}, fused {tr.net.cfg.fused}, "
                  f"sigma net {widths[0]}, color net {widths[1]}")
            check(type(tr.net).__name__ == "NeRFNetworkFF"
                  and tr.net.cfg.compute_dtype == "bfloat16"
                  and tuple(widths) == FF_WIDTHS,
                  f"main_nerf {name} did not build NeRFNetworkFF in bf16")
            check(trained[key] >= 2 * steps, f"main_nerf {name} launched "
                  f"{key} {trained[key]} times in {steps} steps")
            check(after[other] == 0, f"main_nerf {name} launched {other}")
            check(bool(np.isfinite(tr.stats["step_loss"]).all()),
                  f"main_nerf {name}: a training loss is not finite")
            if "-O" in extra:
                check(losses[-1] < losses[0], f"main_nerf {name}: the last"
                      f" epoch's mean loss {losses[-1]} is not under the "
                      f"first's {losses[0]}")
            check((len(frames) == 8 or len(videos) == 2)
                  and np.isfinite(tr.stats["results"][-1]),
                  f"main_nerf {name}: the test split's frames or PSNR")
            # the checkpoint the run left reloads into a fresh net
            net2 = make_network(tr.net.cfg, None, device=dev, opt=tr.opt,
                                trainable=True)
            tr2 = Trainer(tr.opt, net2, ema_decay=0.95, workspace=ws_dir,
                          use_checkpoint="latest", mute=True)
            same = all(torch.equal(a, b) for a, b in zip(
                net2.param_list() + tr2.ema_params,
                tr.net.param_list() + tr.ema_params))
            print(f"main_nerf {name}: checkpoint reloaded at epoch "
                  f"{tr2.epoch}, step {tr2.global_step}; parameters and EMA"
                  f" equal: {same}")
            check(same and tr2.global_step == steps, f"main_nerf {name}: "
                  "the checkpoint does not reload the trained net")
            main_nerf_stats[name] = dict(
                steps=steps, s_per_step=t_steps / steps,
                launches=trained[key], key=key)
            del tr, tr2, net2
            torch.cuda.empty_cache()

    with Phase("cli options"):
        cli = cli_options_phase(torch, fused_mlp, main_nerf, data_dir,
                                data_root.name, smi)
    print("cli_options: " + json.dumps(cli))

    with Phase("kernels K6, K7"):
        gg = torch.Generator(device=dev).manual_seed(6)
        gathers = {}      # (kernel, R, C, M, nslot) -> the timing record
        shapes = [(R, C, M, NSLOTS) for R, C, M in K6_SHAPES] + [
            (R, C, M, NSLOTS) for R, C, M, _ in K7_SHAPES] + [
            (K7_SHAPES[0][0], K7_SHAPES[0][1], RAGGED_M, NSLOTS)]
        for R, C, M, nslots in shapes:
            table = torch.randn((R, C), generator=gg, device=dev)
            idx = torch.randint(0, R, (M,), generator=gg, device=dev,
                                dtype=torch.int32)
            want = gather.gather_plain(table, idx)
            runs = [("K6", None, lambda: gather.vmem_gather(table, idx))] + [
                ("K7", n, lambda n=n: gather.dma_gather(table, idx, nslot=n))
                for n in nslots]
            exact = {}
            for kname, n, call in runs:
                got = call()
                torch.cuda.synchronize()
                exact[(kname, n)] = torch.equal(got, want)
            print(f"R={R} C={C} M={M}: bit-exact against table[idx]: "
                  f"{exact}")
            check(all(exact.values()), f"a row gather is not bit-exact at "
                  f"R={R}, C={C}, M={M}")
            # the probe's own shapes are timed: K6 at section E's, K7 at
            # section F's with the nslots F runs
            k7_nslots = {(r, c, m): ns for r, c, m, ns in K7_SHAPES}
            timed = [("K6", None, runs[0][2])] \
                if (R, C, M) in K6_SHAPES else [
                    (k, n, c) for k, n, c in runs[1:]
                    if n in k7_nslots.get((R, C, M), ())]
            if not timed:
                continue
            # bytes: the indices, each distinct row once, the output once
            rows = int(torch.unique(idx).numel())
            nbytes = M * 4 + rows * C * 4 + M * C * 4
            bound, by = bound_ms(0.0, nbytes)
            plain = cuda_ms(torch, lambda: gather.gather_plain(table, idx),
                            20)
            lib = cuda_ms(torch, lambda: torch.index_select(table, 0, idx),
                          20)
            for kname, n, call in timed:
                ms = cuda_ms(torch, call, 20)
                gathers[(kname, R, C, M, n)] = dict(
                    ms=ms, plain=plain, lib=lib, bound=bound, by=by)
                print(f"{kname}{'' if n is None else f' nslot={n}'} R={R} "
                      f"C={C} M={M} ({rows} distinct rows, "
                      f"{nbytes / 1e6:.1f} MB): kernel_ms {ms:.4f} "
                      f"({1e6 * ms / M:.3f} ns/row), plain_ms {plain:.4f}, "
                      f"library_ms {lib:.4f} (index_select), bound_ms "
                      f"{bound:.4f} ({by}); {smi}")
            del table, idx, want, got
        k6 = gathers[("K6",) + K6_SHAPES[0] + (None,)]
        k7 = gathers[("K7",) + K7_SHAPES[0][:3] + (16,)]
        # the K7 designs of PERF.md beside K7, K6 and index_select
        variants = k7_variants.main()
        check(len(variants) == len(K7_SHAPES)
              and all(r["device"] == smi for r in variants),
              "the K7 variants did not run at every K7 shape")

    with Phase("gather probe"):
        reset_counts()
        records = bench_gather.main(["--quick"])
        torch.cuda.synchronize()
        probe_launches = counts()
        print(f"gather probe: {len(records)} measurements; launches "
              f"{probe_launches}")
        check(probe_launches["K6"] > 0 and probe_launches["K7"] > 0,
              "the gather probe did not launch K6 and K7")
        check(all(r["device"] == smi for r in records),
              "a probe record does not name the card")

    with Phase("bench"):
        # the port's bench (nerfsafetyvalidation_tpu_torch/bench.py) on the
        # spheres scene, as a user runs it: all six modes of bench.py's
        # gate and the reference-backbone line, through K1 at three widths,
        # K3 and K4, with the plain versions' calls counted
        os.environ["BENCH_SCENES"] = "spheres"
        reset_counts()
        t0 = time.perf_counter()
        plain_before = plain_calls()
        line = bench.main([], device="cuda")
        torch.cuda.synchronize()
        t_bench = time.perf_counter() - t0
        bench_launches = counts()
        plain_seen = {k: n - plain_before[k]
                      for k, n in plain_calls().items()}
        by_width = dict(points_mlp.LAUNCHES_BY_WIDTH)
        print(f"bench: {t_bench:.2f} s; launches {bench_launches}, K1 by "
              f"width {by_width}; plain-version calls {plain_seen}; "
              f"headline {line['mode']} {line['value']} rays/s, gate_pass "
              f"{line['gate_pass']}; {smi}")
        check(not any(plain_seen.values()), f"the bench called plain "
              f"versions {plain_seen}")
        check(line["gate_pass"] and line["device"] == smi,
              "the bench's headline did not pass its gate")
        check(line["launches"]["K1"] == {str(h): n for h, n in
                                         sorted(by_width.items())}
              and line["launches"]["K3"] == bench_launches["K3"]
              and line["launches"]["K4"] == bench_launches["K4"],
              "the bench's launch counts are not the run's")
        check(all(by_width.get(h, 0) > 0 for h in (160, 192, 256))
              and bench_launches["K3"] > 0 and bench_launches["K4"] > 0
              and bench_launches["K4 f32"] == 0,
              "the bench did not launch K1 at every width, K3 and K4")
        ref_line = line["ref_backbone"]
        got = {m: (float(np.mean(line["modes"][m]["spheres"]
                                 ["psnr_poses"])),
                   float(np.min(line["modes"][m]["spheres"]["psnr_poses"])))
               for m in bench.MODE_ORDER}
        got["ref_backbone"] = (ref_line["psnr"],) * 2
        got["ref_backbone_ml8"] = (ref_line["masked"]["psnr"],) * 2
        for m, (mean, low) in got.items():
            ref_mean, ref_min = BENCH_R05[m]
            sc = line["modes"].get(m, {})
            print(f"bench {m}: spheres {mean:.3f}/{low:.3f} dB, BENCH_r05 "
                  f"{ref_mean}/{ref_min}, gap {mean - ref_mean:+.3f}/"
                  f"{low - ref_min:+.3f} (band {GAP_BAND}); pass "
                  f"{sc.get('pass')}, {sc.get('rays_per_s')} rays/s")
            check(abs(mean - ref_mean) <= GAP_BAND
                  and abs(low - ref_min) <= GAP_BAND,
                  f"bench {m} PSNR {mean:.3f}/{low:.3f} dB is more than "
                  f"{GAP_BAND} dB from BENCH_r05's {ref_mean}/{ref_min}")

    # ---- the batched rollout engines on the spheres assets
    with Phase("rollouts setup"), torch.inference_mode():
        env = F.envconfig()
        steps = env["steps"]
        lo, hi = SDF_BOX

        def density(pts):
            # world (raw-frame) points -> the NGP frame the field reads
            x = torch.from_numpy(pts[:, [1, 2, 0]].copy()).to(dev)
            return teacher.density(x)["sigma"]

        t0 = time.perf_counter()
        sdf = build_sdf(density, start=lo, end=hi, granularity=40)
        t_sdf = time.perf_counter() - t0
        occupied = float((sdf == 0).mean())
        rnets = {"teacher": teacher, "student_h160": student, "ref": ref}

        def engine(path, net):
            return F.rollout_engine(path, net, state, sdf, lo, 40,
                                    device=dev)

        start = engine("uniform", ref).start_state.cpu().numpy()
        print(f"rollouts: SDF of the teacher's density (> 10) on "
              f"{sdf.shape} cells over {lo}..{hi} m at 40 cells/m, "
              f"{occupied:.4f} of them occupied, max distance "
              f"{sdf.max():.3f} m, built in {t_sdf:.2f} s; envConfig.json: "
              f"{steps} steps of {env['dt']:.4f} s, g {env['g']}, mass "
              f"{env['mass']}, hover action [{env['mass'] * env['g']}, 0, "
              f"0, 0], disturbance std {env['noise_std'].tolist()}; start "
              f"state (held-out pose 0) {np.round(start, 5).tolist()}; "
              f"{F.ROLLOUT_SIMS} sims, {F.ROLLOUT_OBS}^2 observations")
        check(0 < occupied < 0.5, "the SDF's grid is empty or full")
        unfused = {
            "teacher": make_network(replace(F.TEACHER_CFG, fused=False),
                                    teacher.params_tree(),
                                    device=dev).to_folded(),
            "student_h160": make_network(replace(student.cfg, fused=False),
                                         student.params_tree(), device=dev),
            "ref": make_network(replace(ref.cfg, fused=False),
                                ref.params_tree(), device=dev)}
        z = torch.randn((F.ROLLOUT_SIMS, steps, 12), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    def uq_of(eng, out):
        """(the UQ's five inputs [5], sigma_d) of one observation."""
        stats = eng._obs_stats(out)
        return stats[0], float(eng._gaussian_uq_moments(
            *stats.unbind(-1))[1][0])

    def s_d2(out):
        """sum sigma^2 over an observation's shaded slots."""
        if "uq_moments" in out:
            return float(out["uq_moments"][3])
        return float((out["sigmas"].double() ** 2).sum())

    def clip_record(n_hi, n_all, k_out, u_out, sd_k, sd_u):
        return dict(n_hi=n_hi, n_all=n_all, share=n_hi / max(n_all, 1),
                    S_d2_kernel=s_d2(k_out), S_d2_unclipped=s_d2(u_out),
                    sigma_d_kernel=sd_k, sigma_d_unclipped=sd_u)

    def clip_count(eng, path, net_name, o, d, kernel_out):
        """Samples with s0 > 15 among an observation's shaded slots (through
        the unclipped plain chain), and the UQ through the kernel route and
        through that chain."""
        real = unfused[net_name]
        uneng = engine(path, real)
        call = uneng._obs_call()
        plain_out = call(o, d)
        if path == "uniform":
            sig = plain_out["sigmas"]
            n_hi, n_all = int((sig > E15).sum()), sig.numel()
        else:
            kw = dict(call.keywords)
            if path in ("guided", "scout"):
                kw["prepass_net"] = real
            n_hi, n_all = (int(round(float(call.func(
                S0Count(real, every), *call.args[1:], o, d, **kw)[
                    "uq_moments"][2]))) for every in (False, True))
        return clip_record(n_hi, n_all, kernel_out, plain_out,
                           uq_of(uneng, kernel_out)[1],
                           uq_of(uneng, plain_out)[1])

    rollout_launches = {"K1": 0, "K3": 0, "K4": 0}
    rollouts, clipping = {}, {}
    step0 = None
    for path, kernel in ROLLOUT_KERNELS.items():
        net_name = F.ROLLOUT_NETS[path]
        with Phase(f"rollouts {path}"), torch.inference_mode():
            eng = engine(path, rnets[net_name])
            reset_counts()
            plain_before = plain_calls()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.monte_carlo(None, F.ROLLOUT_SIMS, z=z)  # numpy: waits
            t_run = time.perf_counter() - t0
            n = counts()
            plain_seen = {k: v - plain_before[k]
                          for k, v in plain_calls().items()}
            rollout_launches[kernel] += n[kernel]
            sig, rew = out["sigma_d"], out["reward"]
            if step0 is None:
                step0 = out["positions"][:, 0]
            rate = F.ROLLOUT_SIMS / t_run
            per_step = t_run / (F.ROLLOUT_SIMS * steps)
            coll = float(out["ever_collided"].mean())
            print(f"rollouts {path}: {net_name} through {kernel} "
                  f"({n[kernel]} launches; all {n}; plain-version calls "
                  f"{plain_seen}): {t_run:.3f} s, {rate:.3f} rollouts/s, "
                  f"{per_step:.5f} s per sim-step, collision rate {coll}; "
                  f"sigma_d {float(sig.min()):.4g}..{float(sig.max()):.4g}"
                  f", reward {float(rew.min()):.4g}..{float(rew.max()):.4g}"
                  f", risk min {float(out['risk'].min()):.4g}; {smi}")
            check(n[kernel] > 0, f"rollouts {path} never launched {kernel}")
            check(not any(plain_seen.values()),
                  f"rollouts {path} called plain versions {plain_seen}")
            check(bool(np.isfinite(sig).all() and (sig >= 0).all()
                       and np.isfinite(rew).all()),
                  f"rollouts {path}: sigma_d or the reward not finite")
            check(np.array_equal(out["positions"][:, 0], step0),
                  f"rollouts {path}: step 0 landed elsewhere than on the "
                  "first path")
            # one observation (the start state's) through the kernel and
            # through the plain field
            o, d = eng._obs_rays(eng._pose_from_state(
                torch.from_numpy(start).to(dev)[None]))
            call = eng._obs_call()
            k_out = call(o, d)
            p_out = call(o, d, plain_field=True)
            (s_k, sd_k), (s_p, sd_p) = uq_of(eng, k_out), uq_of(eng, p_out)
            img_err = (k_out["image"] - p_out["image"]).abs()
            rel = float(((s_k - s_p).abs()
                         / s_p.abs().clamp(min=1e-30)).max())
            print(f"rollouts {path}: the start's observation, kernel vs "
                  f"plain field: image max abs {float(img_err.max()):.3e}"
                  f", mean {float(img_err.mean()):.3e}; UQ inputs "
                  f"{s_k.tolist()} vs {s_p.tolist()} (max rel {rel:.3e});"
                  f" sigma_d {sd_k:.6g} vs {sd_p:.6g}")
            check(float(img_err.max()) <= TOL_IMG_MAX
                  and float(img_err.mean()) <= TOL_IMG_MEAN
                  and rel <= TOL_UQ_STATS,
                  f"rollouts {path}: the kernel's observation disagrees "
                  f"with the plain field's (image {TOL_IMG_MAX} / "
                  f"{TOL_IMG_MEAN}, UQ inputs rel {TOL_UQ_STATS})")
            clipping[f"rollouts {path}"] = clip_count(eng, path, net_name,
                                                      o, d, k_out)
            rollouts[path] = dict(rollouts_per_s=rate, s=t_run,
                                  s_per_sim_step=per_step,
                                  collision_rate=coll, launches=n[kernel])
            del eng, out, k_out, p_out

    with Phase("rollouts cem"), torch.inference_mode():
        eng = engine("scout", student)
        reset_counts()
        plain_before = plain_calls()
        with tempfile.TemporaryDirectory() as tmp:
            csv_path = os.path.join(tmp, "cem.csv")
            t0 = time.perf_counter()
            res = eng.cem(torch.Generator(device=dev).manual_seed(2),
                          csv_path=csv_path, **CEM_RUN)
            t_cem = time.perf_counter() - t0
            with open(csv_path, newline="") as f:
                n_rows, hits = cem_csv_rows_stop(list(csv.reader(f)), steps)
        n = counts()
        plain_seen = {k: v - plain_before[k] for k, v in plain_calls().items()}
        rollout_launches["K1"] += n["K1"]
        n_roll = CEM_RUN["m"] * CEM_RUN["kmax"]
        print(f"rollouts cem (scout, m {CEM_RUN['m']}, elite "
              f"{CEM_RUN['m_elite']}, kmax {CEM_RUN['kmax']}): {t_cem:.3f} "
              f"s, {n_roll / t_cem:.3f} rollouts/s; history "
              f"{res['history']}; the CSV: {n_rows} rows of 27 columns, "
              f"{hits} sims' rows stopping at a collision; proposal "
              f"variances {float(res['vars'].min()):.3e}.."
              f"{float(res['vars'].max()):.3e}; K1 launches {n['K1']}; "
              f"plain-version calls {plain_seen}; {smi}")
        check(n["K1"] > 0 and not any(plain_seen.values()),
              "the CEM did not run through K1 alone")
        check(bool(np.isfinite(res["means"]).all()
                   and (res["vars"] > 0).all()
                   and (res["vars"] <= 0.1).all()),
              "the CEM's proposal is not finite or leaves (0, 0.1]")
        rollouts["cem"] = dict(rollouts_per_s=n_roll / t_cem, s=t_cem,
                               csv_rows=n_rows, collided=hits,
                               launches=n["K1"])
        del eng

    with Phase("bench_rollouts"):
        reset_counts()
        lines = bench_rollouts.main(device="cuda")
        print(f"bench_rollouts: launches {counts()} (the full engine's net "
              f"is the JAX script's: float32, unfused)")
        check(len(lines) == 2 and all(ln["device"] == smi and ln["value"] > 0
                                      for ln in lines),
              "bench_rollouts did not print its two lines")

    with Phase("sigma clipping"), torch.inference_mode():
        # pose 0 at 800^2: the teacher's fast frame (K3) and the student's
        # baked_h160 frame (K1); then every rollout path's observation
        o, d, _ = views[0]
        eng = engine("fast", teacher)
        for name, kernel_net, real in (
                ("fast", teacher, unfused["teacher"]),
                ("baked_h160", student, unfused["student_h160"])):
            frame = dict(F.MODES[name]["frame"], return_moments=True)
            if name == "fast":
                def render(net, **kw):
                    return render_frame_fast(net, state, o, d, **frame)
            else:
                def render(net, **kw):
                    return render_frame_guided(net, state, o, d, RES, RES,
                                               **kw, **frame)
            k_out, u_out = render(kernel_net), render(real)
            n_hi, n_all = (int(round(float(render(
                S0Count(real, every), prepass_net=real)["uq_moments"][2])))
                for every in (False, True))
            clipping[f"{name} 800^2 pose 0"] = clip_record(
                n_hi, n_all, k_out, u_out, uq_of(eng, k_out)[1],
                uq_of(eng, u_out)[1])
        for what, c in clipping.items():
            print(f"sigma clipping, {what}: {c['n_hi']} of {c['n_all']} "
                  f"shaded samples with s0 > 15 ({c['share']:.3e}); S_d2 "
                  f"kernel {c['S_d2_kernel']:.7g}, unclipped "
                  f"{c['S_d2_unclipped']:.7g}; sigma_d kernel "
                  f"{c['sigma_d_kernel']:.7g}, unclipped "
                  f"{c['sigma_d_unclipped']:.7g}; {smi}")
        print("sigma clipping: " + json.dumps(clipping))
        print("rollouts: " + json.dumps(rollouts))


    # ---- validate (the port's validate CLI, as a user runs it) ----------
    with Phase("validate nets"):
        from nerfsafetyvalidation_tpu_torch.cli import (apply_O_flag,
                                                        build_parser)
        from nerfsafetyvalidation_tpu_torch.data.synthetic import (
            generate_dataset)
        val_dir = str(Path(data_root.name) / f"spheres{VALIDATE_RES}")
        write_dataset(val_dir, generate_dataset(
            n_train=1, n_val=1, n_test=1, H=VALIDATE_RES, W=VALIDATE_RES))
        from nerfsafetyvalidation_tpu_torch.config import (
            network_config_from_opt)
        # refbb.ckpt into the CLI's default net, and its A* grid
        opt = apply_O_flag(build_parser("validate").parse_args(
            [data_dir, "--bound", "1", "--scale", "1"]), "validate")
        net = make_network(network_config_from_opt(opt), None, device=dev,
                           opt=opt, trainable=True)
        with tempfile.TemporaryDirectory() as ws:
            tr = Trainer(opt, net, workspace=ws, mute=True,
                         use_checkpoint=str(ROOT / "bench_assets/refbb.ckpt"))
        refbb_occ = astar_occupied(torch, net)
        print(f"validate nets: refbb.ckpt loads into the CLI's default "
              f"{type(net).__name__} ({net.cfg.compute_dtype}, fused "
              f"{net.cfg.fused}) at step {tr.global_step}; A*'s 20^3 grid "
              f"{refbb_occ:.4f} occupied")
        del net, tr
        reset_counts()
        ws_unfused = str(Path(data_root.name) / "ws_unfused")
        t0 = time.perf_counter()
        tr = main_nerf.main([data_dir, "--workspace", ws_unfused, "--bound",
                             "1", "--scale", "1", "--seed", "0",
                             *VALIDATE_UNFUSED], device="cuda")
        t_unfused = time.perf_counter() - t0
        n = counts()
        unfused_occ = astar_occupied(torch, tr.net)
        print(f"validate nets: main_nerf {' '.join(VALIDATE_UNFUSED)}: "
              f"{type(tr.net).__name__} ({tr.net.cfg.compute_dtype}, fused "
              f"{tr.net.cfg.fused}), {tr.global_step} steps, last epoch's "
              f"loss {tr.stats['loss'][-1]:.6f}, {t_unfused:.2f} s; A*'s "
              f"20^3 grid {unfused_occ:.4f} occupied; K4 launches "
              f"{n['K4']}, {n['K4 f32']} (f32); {smi}")
        check(type(tr.net).__name__ == "NeRFNetwork" and not tr.net.cfg.fused
              and tr.net.cfg.compute_dtype == "float32"
              and n["K4"] == n["K4 f32"] == 0,
              "validate's unfused net is not the CLI's float32 NeRFNetwork")
        del tr
    ckpts = {k: sorted(Path(data_root.name, ws, "checkpoints").glob(
        "ngp_ep*.ckpt"))[-1] for k, ws in (("ff", "ws0"),
                                           ("unfused", "ws_unfused"))}
    validate_stats = {"nets": dict(refbb_astar_occupied=refbb_occ,
                                   unfused_astar_occupied=unfused_occ,
                                   unfused_train_s=t_unfused)}
    k4_validate = {"astar": 0, "learn_init": 0, "observations": 0}
    keep_ff = str(Path(data_root.name) / "kept_validate_ff_mc")
    keep_seq = str(Path(data_root.name) / "kept_sequential")
    for name, extra, stress, sims, ckpt in VALIDATE_RUNS:
        with Phase(f"validate {name}"):
            validate_stats[name] = validate_phase(
                torch, validate_cli, val_dir, extra, stress, sims,
                ckpts[ckpt], smi, keep=keep_ff if name == "--ff MC" else None)
            for place, n in validate_stats[name]["k4"].items():
                k4_validate[place] += n
    for name, extra, msg in VALIDATE_REFUSALS:
        with Phase(f"validate refuses {name}"):
            validate_refusal(validate_cli, val_dir, extra, msg)
    for name, extra, msg in SEQUENTIAL_REFUSALS:
        with Phase(f"validate refuses {name}"):
            validate_refusal(validate_cli, val_dir, extra, msg,
                             batched=False)
    print("validate: " + json.dumps(validate_stats))

    # ---- the sequential path: validate's default command, CEM, simulate -
    seq_stats = sequential_phase(torch, validate_cli, val_dir,
                                 ckpts["unfused"], smi, keep=keep_seq)
    with Phase("simulate"):
        seq_stats["simulate"] = simulate_phase(
            torch, val_dir, ckpts["unfused"], seq_stats["MC"]["path"], smi)
    print("sequential: " + json.dumps(seq_stats))

    # ---- the Bayesian-Laplace UQ: K4 grouped, uncertain, validate -------
    laplace = laplace_phases(torch, fused_mlp, validate_cli, data_root.name,
                             ckpts["ff"], ckpts["unfused"], val_dir, smi)
    print("laplace: " + json.dumps(laplace))
    k4g = laplace["k4_grouped"]

    # ---- validate --fast_render and --r ----------------------------------
    fast = fast_render_phases(torch, validate_cli, ckpts["ff"],
                              ckpts["unfused"], val_dir, keep_ff, keep_seq,
                              data_root.name, smi)
    print("fast_render: " + json.dumps(fast))
    data_root.cleanup()

    # ---- distillation (models/bake.py): the student through K3's teacher
    with Phase("distill"):
        dist = distill_phase(torch, teacher, state, smi)
    print("distill: " + json.dumps(dist))

    # ---- float32: K3 and K1 in f32, K3's backward, the fused teacher
    with Phase("f32"):
        f32 = f32_phase(torch, teacher, state, views, k1_pts, k3_pts,
                        mode_psnr, smi)
    print("f32: " + json.dumps(f32))

    print(f"total {time.perf_counter() - t_start:.2f} s")
    pallas = "nerfsafetyvalidation_tpu/ops/pallas/render_mlp.py"
    kernel_line = {"kernels": [
        {"name": "fused_points_sigma_color", "route": "cuda",
         "source": "nerfsafetyvalidation_tpu_torch/csrc/points_mlp.cu",
         "replaces": f"{pallas}:480", "launches": launches["K1"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib_ms,
         "shapes": k1_shapes, "launches_bench": bench_launches["K1"],
         "launches_bench_by_width": by_width,
         "launches_rollouts": rollout_launches["K1"],
         "launches_distill": dist["k1_launches"]},
        {"name": "fused_sigma_color_deep", "route": "cuda",
         "source": "nerfsafetyvalidation_tpu_torch/csrc/points_mlp.cu",
         "replaces": f"{pallas}:302", "launches": k2_launches,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib_ms,
         "ms_f32": k2_ms32, "plain_ms_f32": k2_plain_ms32,
         "bound_ms_f32": k2_bound32, "bound_by_f32": k2_by32,
         "bound_ms_f32_ffma": k2_bound32_ffma,
         "library_ms_f32": k2_lib_ms32},
        {"name": "fused_sigma_color", "route": "cuda",
         "source": "nerfsafetyvalidation_tpu_torch/csrc/sigma_color.cu",
         "replaces": f"{pallas}:164", "launches": launches["K3"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": k3_lib_ms,
         "ms_cold": k3_cold, "shapes": k3_shapes,
         "launches_bench": bench_launches["K3"],
         "launches_rollouts": rollout_launches["K3"],
         "launches_distill": {p: dist[p]["k3_launches"]
                              for p in ("distill", "finetune")},
         "launches_train_fused": f32["k3_bf16_train"],
         "backward": f32["backward"]["bfloat16"]},
        {"name": "fused_mlp", "route": "cuda",
         "source": "nerfsafetyvalidation_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "nerfsafetyvalidation_tpu/ops/pallas/fused_mlp.py:91",
         "launches": launches["K4"], "max_abs_err": k4_err, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": k4_lib_ms, "ms_cold": k4_cold,
         "launches_f32": staged["staged"]["launches"],
         "max_abs_err_f32": k4_err32, "ms_f32": k4_ms32,
         "ms_cold_f32": k4_cold32, "plain_ms_f32": k4_plain_ms32,
         "bound_ms_f32": k4_bound32, "bound_by_f32": k4_by32,
         "bound_ms_f32_ffma": k4_bound32_ffma,
         "bound_by_f32_ffma": k4_by32_ffma,
         "library_ms_f32": k4_lib_ms32,
         "launches_main_nerf_O_ff": main_nerf_stats["-O --ff"]["launches"],
         "launches_main_nerf_ff": main_nerf_stats["--ff"]["launches"],
         "launches_bench": bench_launches["K4"],
         "launches_rollouts": rollout_launches["K4"],
         "launches_validate": k4_validate,
         "launches_uncertain": {
             k: laplace[f"uncertain {k}"]["launches"]
             for k in ("laplace", "gaussian")},
         "launches_validate_laplace":
             laplace["validate --ff MC laplace"]["k4_all"],
         "launches_validate_fast_render": {
             k: v["k4"] for k, v in
             fast["validate --ff --fast_render MC"].items()},
         "launches_cli_options": cli["k4"]},
        {"name": "fused_mlp_grouped", "route": "cuda",
         "source": "nerfsafetyvalidation_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "nerfsafetyvalidation_tpu/ops/pallas/fused_mlp.py:91",
         "launches": laplace["validate --ff MC laplace"]["k4_grouped"],
         "max_abs_err": k4g["err"], "ms": k4g["ms"],
         "plain_ms": k4g["plain_ms"], "bound_ms": k4g["bound"],
         "bound_by": k4g["by"], "library_ms": k4g["lib_ms"]},
    ] + [
        {"name": name, "route": "cuda",
         "source": "nerfsafetyvalidation_tpu_torch/csrc/fold_build.cu",
         "replaces": f"nerfsafetyvalidation_tpu/ops/pallas/fold_build.py:"
                     f"{line}", "launches": n,
         "max_abs_err": k5[bf]["err"], "ms": k5[bf][ms],
         "plain_ms": k5[bf][plain], "bound_ms": k5[bf]["bound"],
         "bound_by": k5[bf]["by"], "library_ms": lib}
        for name, line, n, ms, plain, lib in (
            ("fold_build", 45, train_launches[0], "ms", "plain",
             k5[bf]["plain"]),
            ("fold_build_bwd", 56, train_launches[1], "ms_b", "plain_b",
             k5[bf]["lib_b"]))
    ] + [
        {"name": name, "route": "cuda",
         "source": "nerfsafetyvalidation_tpu_torch/csrc/gather_rows.cu",
         "replaces": f"scripts/bench_gather.py:{line}",
         "launches": probe_launches[key], "max_abs_err": 0.0,
         "ms": rec["ms"], "plain_ms": rec["plain"], "bound_ms": rec["bound"],
         "bound_by": rec["by"], "library_ms": rec["lib"]}
        for name, line, key, rec in (("pallas_vmem_gather", 147, "K6", k6),
                                     ("pallas_dma_gather", 190, "K7", k7))
    ] + [
        {"name": "fused_points_sigma_color_f32", "route": "cuda",
         "source": "nerfsafetyvalidation_tpu_torch/csrc/points_mlp.cu",
         "replaces": f"{pallas}:480", "launches": f32["k1_launches"],
         "max_abs_err": f32["k1"]["max_abs_err"], "ms": f32["k1"]["ms"],
         "plain_ms": f32["k1"]["plain_ms"], "bound_ms": f32["k1"]["bound_ms"],
         "bound_by": f32["k1"]["bound_by"],
         "bound_ms_ffma": f32["k1"]["bound_ms_ffma"],
         "library_ms": f32["k1"]["library_ms"],
         "shapes": f32["k1"]["shapes"]},
        {"name": "fused_sigma_color_f32", "route": "cuda",
         "source": "nerfsafetyvalidation_tpu_torch/csrc/sigma_color.cu",
         "replaces": f"{pallas}:164", "launches": f32["k3_launches"],
         "max_abs_err": f32["k3"]["max_abs_err"], "ms": f32["k3"]["ms"],
         "plain_ms": f32["k3"]["plain_ms"], "bound_ms": f32["k3"]["bound_ms"],
         "bound_by": f32["k3"]["bound_by"],
         "library_ms": f32["k3"]["library_ms"],
         "ms_cold": f32["k3"]["ms_cold"], "shapes": f32["k3"]["shapes"],
         "launches_frames": f32["k3_launches_frames"],
         "launches_train_fused": f32["train"]["float32"]["launches"][
             "K3 f32"],
         "backward": f32["backward"]["float32"]},
    ]}
    check(len(kernel_line["kernels"]) == 11 and all(
              k["launches"] > 0 for k in kernel_line["kernels"])
          and kernel_line["kernels"][3]["launches_f32"] > 0
          and all(kernel_line["kernels"][i]["launches_rollouts"] > 0
                  for i in (0, 2, 3))
          and kernel_line["kernels"][0]["launches_distill"] > 0
          and all(kernel_line["kernels"][2]["launches_distill"].values())
          and kernel_line["kernels"][2]["launches_train_fused"] > 0
          and kernel_line["kernels"][10]["launches_train_fused"] > 0
          and all(k4_validate.values())
          and all(v > 0 for k, v in cli["k4"].items() if k != "tcnn")
          and cli["k4"]["tcnn"] == 0,
          "a kernel of the slice's paths was never launched")
    print(json.dumps(kernel_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))


# ---- float32 (phase 34): K3 and K1 in f32, K3's backward, the f32 frames,
# the fused mip-fold teacher trained -------------------------------------
# Each f32 kernel against its plain version in f32 (TF32 off): JAX's own
# kernel-vs-XLA tolerance in float32 (tests/test_fused_mlp.py:263-269), on
# sigma and rgb. K3 f32 sums in order with FFMA, cuBLAS in its own order;
# K1 f32 takes three tf32 products a multiply-add (each about 2^-21 of
# it): ~1e-6 relative expected.
TOL_F32 = dict(rtol=5e-4, atol=1e-5)
# the fused training runs: TRAIN_CFG's widths with fused=True, on phase
# 11's 48-view 200x200 set, one epoch each (bf16, then f32), the budget
# switch at F32_WARMUP; the f32 run folds its warm-up steps at
# F32_FOLD_WARMUP (fold_warmup_scale; the native F is 128). The mean loss
# of the last F32_LOSS_STEPS steps must lie under the first's.
F32_TRAIN_STEPS, F32_WARMUP, F32_FOLD_WARMUP = 48, 24, 64
F32_LOSS_STEPS = 8
# One step through K3 against one through its plain forward from the
# trained parameters, state and the same draws. The backward is the same
# recompute on both routes; the forwards differ by the sum order (f32:
# ~1e-6 relative a row; bf16: now and then an activation on the
# neighbouring bf16 value, 2^-8 = 3.9e-3 of it), which moves the loss and
# the gradients a little. Bounds: the loss within `loss` relative; each
# tensor's gradients within `grad` of its largest gradient (f32: ten
# times the sum order's spread; bf16: 2.5 bf16 steps). A fresh Trainer's
# Adam step is lr * g / (|g| + 1e-15), about lr * sign(g), so two updates
# more than 1e-6 apart mean that the gradient changed sign or left zero:
# each such entry's gradient must lie within `grad` of zero, and at most
# `apart` entries in all tensors may be so. Measured (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 6): f32 loss and gradients bit-equal, no
# entry apart; bf16 loss bit-equal, gradients up to 1.14e-3 of their
# largest apart, 19 entries of the hash table apart (2.8e-7 of it), each
# at a gradient near zero.
TOL_K3_STEP = {"float32": dict(loss=1e-5, grad=1e-5, apart=10),
               "bfloat16": dict(loss=1e-3, grad=1e-2, apart=200)}


def f32_phase(torch, teacher, state, views, k1_pts, k3_pts, bf16_psnr, smi):
    """Phase 34 (see the module docstring): K3 and K1 in float32 against
    their plain versions, K3's backward in both dtypes, the f32 teacher's
    and student's frames, and the fused teacher trained in bf16 and f32.
    `bf16_psnr` maps fast, guided and baked_h160_ak8 to the mean PSNR of
    their bf16 frames. Returns its numbers."""
    import functools

    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch.models import make_network
    from nerfsafetyvalidation_tpu_torch.ops.freq_encoding import freq_encode
    from nerfsafetyvalidation_tpu_torch.ops.hopper import (fold_build,
                                                           points_mlp,
                                                           sigma_color)
    from nerfsafetyvalidation_tpu_torch.ops.sh_encoding import sh_encode
    from nerfsafetyvalidation_tpu_torch.train.trainer import Trainer
    f32, bf = torch.float32, torch.bfloat16
    dev = views[0][0].device
    framed = {}

    def zero():
        points_mlp.LAUNCHES_BY_WIDTH.clear()
        points_mlp.LAUNCHES_F32 = 0
        sigma_color.LAUNCHES = sigma_color.LAUNCHES_F32 = 0
        fold_build.LAUNCHES = fold_build.LAUNCHES_BWD = 0

    def launched():
        return {"K1": sum(points_mlp.LAUNCHES_BY_WIDTH.values()),
                "K1 f32": points_mlp.LAUNCHES_F32,
                "K3": sigma_color.LAUNCHES,
                "K3 f32": sigma_color.LAUNCHES_F32,
                "K5": fold_build.LAUNCHES, "K5 bwd": fold_build.LAUNCHES_BWD}

    def hold(name, got, want, against="plain"):
        """Kernel (sigma, rgb) against plain (or `against`) at TOL_F32;
        returns the largest absolute error."""
        n = want[0].shape[0]
        check(got[0].shape == (n,) and got[1].shape == (n, 3)
              and bool(torch.isfinite(got[0]).all()
                       and torch.isfinite(got[1]).all()),
              f"{name}: outputs not finite [N], [N, 3]")
        errs = []
        for what, a, b in (("sigma", got[0], want[0]),
                           ("rgb", got[1], want[1])):
            err = (a - b).abs()
            rel = err / b.abs().clamp(min=1e-30)
            errs.append(float(err.max()))
            print(f"{name} vs {against} on {n} rows: {what} max abs "
                  f"{float(err.max()):.3e}, mean {float(err.mean()):.3e}, "
                  f"max rel {float(rel.max()):.3e} (rtol {TOL_F32['rtol']}"
                  f", atol {TOL_F32['atol']})")
            check(torch.allclose(a, b, **TOL_F32),
                  f"{name} {what} disagrees with the {against} version")
        return max(errs)

    with torch.inference_mode():
        teacher32 = F.load_teacher_net(dev, compute_dtype="float32")[0]
    tsn, tcn = list(teacher32.sigma_net), list(teacher32.color_net)
    mats32 = sigma_color._prepare(tsn, tcn, f32)["mats"]
    # the function's own products (W1, W2, C1's 31 rows, C2, C3's 3 columns)
    macs3 = sum(w.numel() for w in tsn + tcn)

    # ---- K3 f32 at the guided tile (262,144 rows) and the fast tile
    k3 = dict(shapes=[])
    with torch.inference_mode():
        for tile, (xyz, dirs) in (("guided", k3_pts["guided"]),
                                  ("fast", k3_pts["fast"])):
            enc = teacher32.encode_pos(xyz).contiguous()
            sh = sh_encode(dirs).contiguous()
            rows = enc.shape[0]

            def kern(enc=enc, sh=sh):
                return sigma_color.fused_sigma_color(enc, sh, tsn, tcn, f32)

            def plain(enc=enc, sh=sh):
                return sigma_color.fused_sigma_color_plain(enc, sh, tsn,
                                                           tcn, f32)

            def library(enc=enc, sh=sh):
                # the six products as f32 torch.matmul calls, TF32 off
                w1, w2, c1s, c1g, c2, c3 = mats32
                h = torch.relu(enc @ w1)
                s = h @ w2
                g = torch.relu(sh @ c1s + s @ c1g)
                g = torch.relu(g @ c2)
                return (torch.exp(torch.clamp(s[:, 0], -15.0, 15.0)),
                        torch.sigmoid((g @ c3)[:, :3]))

            zero()
            got = kern()
            torch.cuda.synchronize()
            check(launched()["K3 f32"] == 1 and launched()["K3"] == 0,
                  "K3 f32 did not launch its kernel once")
            err = hold(f"K3 f32 {tile} tile", got, plain())
            hold(f"K3 f32 {tile} tile, library chain", library(), plain())
            same = reruns_equal(torch, kern, got)
            print(f"K3 f32 {tile} tile: {same} of {RERUNS} reruns "
                  f"bit-identical to the first")
            check(same == RERUNS, "K3 f32 gives other values on a rerun")
            nbytes = rows * (32 * 4 + 16 * 4 + 4 * 4) + 4 * macs3
            bound, by = bound_ms(2.0 * rows * macs3, nbytes, PEAK_F32_FLOPS)
            bound_tf32 = bound_ms(3 * 2.0 * rows * macs3, nbytes,
                                  PEAK_TF32_FLOPS)[0]
            ms = cuda_ms(torch, kern, 20)
            plain_ms = cuda_ms(torch, plain, 5)
            lib_ms = cuda_ms(torch, library, 10)
            in_bytes = rows * (32 * 4 + 16 * 4)

            def copy(enc=enc, sh=sh):
                e, s_ = enc.clone(), sh.clone()
                return lambda: sigma_color.fused_sigma_color(e, s_, tsn, tcn,
                                                             f32)
            cold, copies = cold_ms(torch, copy, in_bytes, 20)
            print(f"K3 f32 at {rows} rows ({tile} tile, {macs3} MAC/row): "
                  f"kernel_ms {ms:.4f} (warm), cold {cold:.4f} ({copies} "
                  f"copies of {in_bytes / 1e6:.1f} MB in turn), plain_ms "
                  f"{plain_ms:.4f}, library_ms {lib_ms:.4f} (f32 "
                  f"torch.matmul, TF32 "
                  f"{torch.backends.cuda.matmul.allow_tf32}), bound_ms "
                  f"{bound:.4f} ({by}, 67 TFLOP/s f32; as three TF32 "
                  f"products {bound_tf32:.4f}); {smi}")
            k3["shapes"].append(dict(rows=rows, ms=ms, ms_cold=cold,
                                     plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound, bound_by=by,
                                     bound_ms_tf32=bound_tf32,
                                     max_abs_err=err))
            del enc, sh, got
    k3.update({k: k3["shapes"][0][k] for k in ("ms", "ms_cold", "plain_ms",
                                               "library_ms", "bound_ms",
                                               "bound_by")})
    k3["max_abs_err"] = max(r["max_abs_err"] for r in k3["shapes"])

    # ---- K3's backward at the guided tile, bf16 and f32
    backward = {}
    g3 = torch.Generator(device=dev).manual_seed(34)
    xyz, dirs = (t.clone() for t in k3_pts["guided"])
    for name, dt, net in (("bfloat16", bf, teacher), ("float32", f32,
                                                        teacher32)):
        with torch.no_grad():
            enc0 = net.encode_pos(xyz).contiguous()
            sh0 = sh_encode(dirs).to(dt).contiguous()
        leaves = [enc0.clone().requires_grad_(), sh0.clone().requires_grad_()]
        leaves += [w.detach().clone().requires_grad_()
                   for w in list(net.sigma_net) + list(net.color_net)]
        cot = torch.randn((enc0.shape[0], 4), generator=g3, device=dev)
        key = "K3" if dt is bf else "K3 f32"

        def grads(fn, leaves=leaves, cot=cot, dt=dt):
            s, c = fn(leaves[0], leaves[1], leaves[2:4], leaves[4:], dt)
            loss = (s * cot[:, 0]).sum() + (c * cot[:, 1:]).sum()
            return torch.autograd.grad(loss, leaves)

        with torch.autograd.set_detect_anomaly(False):
            zero()
            got = grads(sigma_color.fused_sigma_color)
            n_fwd = launched()
            want = grads(sigma_color.fused_sigma_color_plain)
            same = [torch.equal(a, b) for a, b in zip(got, want)]
            ms = cuda_ms(torch, lambda: grads(sigma_color.fused_sigma_color),
                         5)
            plain_ms = cuda_ms(torch, lambda: grads(
                sigma_color.fused_sigma_color_plain), 5)
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        print(f"K3 {name} backward at {enc0.shape[0]} rows: launches "
              f"{n_fwd}; (enc, sh, W1, W2, C1, C2, C3) gradients equal to "
              f"the plain recompute's VJP: {same}; finite {finite}; forward "
              f"and backward {ms:.4f} ms (kernel forward, recompute "
              f"backward), {plain_ms:.4f} ms (plain forward and backward); "
              f"{smi}")
        check(n_fwd[key] == 1 and sum(n_fwd.values()) == 1,
              f"K3 {name} with gradients did not launch its kernel once")
        check(all(same) and finite, f"K3 {name}'s gradients differ from "
              "the plain recompute's")
        backward[name] = dict(rows=enc0.shape[0], grads_bit_equal=all(same),
                              ms_fwd_bwd=ms, plain_ms_fwd_bwd=plain_ms)
        del leaves, cot, got, want, enc0, sh0
    torch.cuda.empty_cache()

    def frames(mode, nets, key, other, barred=True):
        """The four poses through `nets` in `mode`, counts at 0 before each
        frame: `key` launched in every frame and `other` never; mean PSNR
        at the bar; pose 0 again through the plain field, compared."""
        kind = F.MODES[mode]["kernel"]
        per, psnrs, outs = [], [], []
        t0 = time.perf_counter()
        with torch.inference_mode():
            for o, d, gt_ in views:
                zero()
                out = F.render(mode, nets, state, o, d)
                per.append(launched())
                outs.append(out)
            torch.cuda.synchronize()
            t_frames = time.perf_counter() - t0
            for out, (_, _, gt_) in zip(outs, views):
                img = out["image"]
                check(img.shape == (F.RES * F.RES, 3)
                      and bool(torch.isfinite(img).all()),
                      f"{mode} f32 image is not finite")
                pred = img.cpu().numpy().reshape(gt_.shape).astype(
                    np.float64)
                psnrs.append(float(-10.0 * np.log10(max(
                    np.mean((pred - gt_) ** 2), 1e-10))))
            zero()
            plain = F.render(mode, nets, state, *views[0][:2],
                             plain_field=True)
            plain_launches = launched()
        err = (plain["image"] - outs[0]["image"]).abs()
        mean = float(np.mean(psnrs))
        print(f"{mode} f32 ({kind} f32): PSNR per pose "
              f"{[round(p, 3) for p in psnrs]}, mean {mean:.3f} (bar "
              f"{PSNR_BAR if barred else None}), the bf16 frames' "
              f"{bf16_psnr[mode]:.3f}, gap {mean - bf16_psnr[mode]:+.4f} dB;"
              f" launches per frame {[p[key] for p in per]} ({other} "
              f"{[p[other] for p in per]}); 4 frames {t_frames:.3f} s "
              f"(first pass); pose 0 vs its plain frame: image max abs "
              f"{float(err.max()):.3e}, mean {float(err.mean()):.3e}; {smi}")
        check(all(p[key] > 0 and p[other] == 0 for p in per),
              f"{mode} f32 did not launch {key} in every frame, or "
              f"launched {other}")
        check(sum(plain_launches.values()) == 0,
              f"the plain {mode} f32 frame launched a kernel")
        check(mean >= PSNR_BAR, f"{mode} f32 mean PSNR {mean:.3f} dB under "
              f"{PSNR_BAR}")
        check(float(err.max()) <= TOL_IMG_MAX
              and float(err.mean()) <= TOL_IMG_MEAN,
              f"{mode} f32 kernel frame disagrees with the plain frame")
        framed[mode] = dict(psnr=psnrs, mean=mean, gap_bf16=mean
                        - bf16_psnr[mode], launches=[p[key] for p in per],
                        s_4frames=t_frames, plain_max_abs=float(err.max()))
        return sum(p[key] for p in per)

    # ---- the f32 teacher's frames
    k3_frames = sum(frames(m, {"teacher": teacher32}, "K3 f32", "K3")
                    for m in ("fast", "guided"))

    # ---- K1 f32 at phase 4's rows, the committed students
    x, d = k1_pts
    sh = sh_encode(d).contiguous()
    k1 = dict(shapes=[])
    students = {}
    with torch.inference_mode():
        for hid in (160, 192, 256):
            net = F.load_student_net(dev, hidden=hid, compute_dtype="float32")
            students[hid] = net
            sn, cn = list(net.sigma_net), list(net.color_net)

            def kern(sn=sn, cn=cn):
                return points_mlp.fused_points_sigma_color(x, sh, sn, cn, 12,
                                                           f32)

            def plain(sn=sn, cn=cn):
                return points_mlp.fused_points_sigma_color_plain(
                    x, sh, sn, cn, 12, f32)

            def library(sn=sn, cn=cn):
                # the chain as f32 torch.matmul calls, TF32 off
                h = freq_encode(x, 12)
                for i, w in enumerate(sn):
                    h = h @ w
                    if i != len(sn) - 1:
                        h = torch.relu(h)
                g = torch.cat([sh, h[:, 1:]], dim=-1)
                for i, w in enumerate(cn):
                    g = g @ w
                    if i != len(cn) - 1:
                        g = torch.relu(g)
                return (torch.exp(torch.clamp(h[:, 0], -15.0, 15.0)),
                        torch.sigmoid(g[:, :3]))

            zero()
            got = kern()
            torch.cuda.synchronize()
            check(launched()["K1 f32"] == 1 and launched()["K1"] == 0,
                  "K1 f32 did not launch its kernel once")
            err = hold(f"K1 f32 H={hid}", got, plain())
            hold(f"K1 f32 H={hid}, library chain", library(), plain())
            same = reruns_equal(torch, kern, got)
            print(f"K1 f32 H={hid}: {same} of {RERUNS} reruns bit-identical "
                  f"to the first")
            check(same == RERUNS, f"K1 f32 H={hid} gives other values on a "
                  "rerun")
            # its arithmetic in plain PyTorch on the same inputs (3xTF32,
            # each sum rounded to nearest in f32, as the tensor cores'
            # sums need not be), and a control: lo @ W_hi left out in every
            # layer, the fault of a dropped product, which TOL_F32 must see
            enc = freq_encode(x, 12)
            emu = points_mlp.fused_sigma_color_deep_tf32_emulated(enc, sh,
                                                                  sn, cn)
            hold(f"K1 f32 H={hid}", got, emu, "3xTF32 emulation")
            hold(f"K1 f32 H={hid}, 3xTF32 emulation", emu, plain())
            ctl = points_mlp.fused_sigma_color_deep_tf32_emulated(
                enc, sh, sn, cn, products=2)
            want = plain()
            ctl_rel = float(((ctl[0] - want[0]).abs() / want[0]).max())
            print(f"K1 f32 H={hid}, control (2xTF32: lo @ W_hi left out): "
                  f"sigma max rel {ctl_rel:.3e} vs plain, rgb max abs "
                  f"{float((ctl[1] - want[1]).abs().max()):.3e}")
            check(not (torch.allclose(ctl[0], want[0], **TOL_F32)
                       and torch.allclose(ctl[1], want[1], **TOL_F32)),
                  f"TOL_F32 cannot tell a dropped tf32 product at H={hid}")
            if hid == 160:
                # K2 f32 (the kernel reading enc) on phase 4's K2 probe's
                # rows and weights, against its plain version and its
                # arithmetic
                got2 = points_mlp.fused_sigma_color_deep(enc, sh, sn, cn,
                                                         f32)
                compare(torch, "K2 f32 H=160", got2,
                        points_mlp.fused_sigma_color_deep_plain(
                            enc, sh, sn, cn, f32), TOL_K2_F32)
                print("K2 f32 H=160 against its 3xTF32 emulation:")
                compare(torch, "K2 f32 H=160", got2, emu, TOL_K2_F32)
                del got2
            del enc, emu, ctl, want
            macs = sum(w.shape[0] * w.shape[1] for w in sn + cn)
            nbytes = K1_ROWS * (3 * 4 + 16 * 4 + 4 * 4) \
                + 4 * sum(w.numel() for w in sn + cn)
            # the route's bound: three tf32 products a multiply-add; and
            # the FFMA bound (67 TFLOP/s f32) as bound_ms_ffma
            bound, by = bound_ms(3 * 2.0 * K1_ROWS * macs, nbytes,
                                 PEAK_TF32_FLOPS)
            bound_ffma = bound_ms(2.0 * K1_ROWS * macs, nbytes,
                                  PEAK_F32_FLOPS)[0]
            # the weight image, streamed from L2 once per 128-row tile, as
            # the design counts it (modelled, not measured)
            l2 = points_mlp.f32_stream_bytes(hid, len(sn) - 2,
                                             len(cn) - 2) * -(-K1_ROWS // 128)
            ms = cuda_ms(torch, kern, 10)
            plain_ms = cuda_ms(torch, plain, 5)
            lib_ms = cuda_ms(torch, library, 5)
            print(f"K1 f32 H={hid} at {K1_ROWS} rows ({macs} MAC/row): "
                  f"kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, library_ms "
                  f"{lib_ms:.4f} (f32 torch.matmul, TF32 "
                  f"{torch.backends.cuda.matmul.allow_tf32}), bound_ms "
                  f"{bound:.4f} ({by}, three TF32 products at 495 TFLOP/s; "
                  f"{100 * bound / ms:.0f}%), FFMA bound {bound_ffma:.4f} (67"
                  f" TFLOP/s f32; {100 * bound_ffma / ms:.0f}%); the weight "
                  f"stream, modelled: {l2 / 1e9:.3f} GB from L2 a launch, "
                  f"{l2 / ms / 1e9:.2f} TB/s over kernel_ms; {smi}")
            k1["shapes"].append(dict(hidden=hid, rows=K1_ROWS, ms=ms,
                                     plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound, bound_by=by,
                                     bound_ms_ffma=bound_ffma,
                                     max_abs_err=err))
            del got
    k1.update({k: k1["shapes"][0][k] for k in ("ms", "plain_ms",
                                               "library_ms", "bound_ms",
                                               "bound_by", "bound_ms_ffma")})
    k1["max_abs_err"] = max(r["max_abs_err"] for r in k1["shapes"])

    # ---- the f32 student's frames
    k1_frames = frames("baked_h160_ak8", {"student_h160": students[160]},
                       "K1 f32", "K1")
    del students
    torch.cuda.empty_cache()

    # ---- the fused teacher trained, bf16 then f32 (fold warm-up)
    opts = {"bfloat16": F.train_opt(iters=F32_TRAIN_STEPS,
                                    grid_warmup_steps=F32_WARMUP),
            "float32": F.train_opt(iters=F32_TRAIN_STEPS,
                                   grid_warmup_steps=F32_WARMUP,
                                   fold_warmup_scale=F32_FOLD_WARMUP)}
    dataset = F.train_dataset(dev, opt=opts["bfloat16"])
    folds = []
    real_fwd = fold_build.fold_build_forward

    def recording_fwd(V, Fk, Cd):
        folds.append(Fk)
        return real_fwd(V, Fk, Cd)

    train = {}
    for name, opt in opts.items():
        dt = bf if name == "bfloat16" else f32
        key, other = ("K3", "K3 f32") if dt is bf else ("K3 f32", "K3")
        epoch_end = []
        folds.clear()
        zero()
        fold_build.fold_build_forward = recording_fwd
        try:
            t0 = time.perf_counter()
            net, t_state, trainer = F.train_flagship(
                dev, iters=F32_TRAIN_STEPS, opt=opt, dataset=dataset,
                on_epoch=lambda tr: epoch_end.append(time.perf_counter()),
                fused=True, compute_dtype=name)
            torch.cuda.synchronize()
        finally:
            fold_build.fold_build_forward = real_fwd
        n = launched()
        steps = trainer.global_step
        t_train = epoch_end[-1] - t0
        losses = np.asarray(trainer.stats["step_loss"])
        first = float(losses[:F32_LOSS_STEPS].mean())
        last = float(losses[-F32_LOSS_STEPS:].mean())
        # the steps before grid_warmup_steps (global_step 1 .. 23) fold at
        # the warm-up scale
        warm = F32_WARMUP - 1 if getattr(opt, "fold_warmup_scale", 0) else 0
        want_folds = [F32_FOLD_WARMUP] * warm + [trainer.net.mip_spec.F] * (
            steps - warm)
        print(f"train fused {name}: {steps} steps in {t_train:.2f} s = "
              f"{t_train / steps:.5f} s/step; launches {n}; fold scales "
              f"of the K5 launches {sorted(set(folds))} "
              f"({folds.count(F32_FOLD_WARMUP)} at {F32_FOLD_WARMUP}); loss "
              f"first {F32_LOSS_STEPS} steps "
              f"{first:.6f}, last {last:.6f}; {smi}")
        check(steps == F32_TRAIN_STEPS, f"trained {steps} steps")
        check(n[key] >= steps and n[other] == 0,
              f"the fused {name} run did not launch {key} every step, or "
              f"launched {other}")
        check(n["K5"] == steps and n["K5 bwd"] == steps,
              f"K5 launched {n['K5']} / {n['K5 bwd']} times in {steps} "
              "steps, not once forward and once backward a step")
        check(folds == want_folds, f"the {name} run's K5 folds at "
              f"{folds}, not {want_folds}")
        check(bool(np.isfinite(losses).all()) and last < first,
              f"the fused {name} loss is not finite or did not fall")

        # one step through K3 and one through its plain forward, from the
        # trained parameters and state, with the same batch and draws
        g = torch.Generator(device=dev).manual_seed(11)
        batch = dataset.collate([0], g)
        bg = torch.rand((1, batch["rays_o"].shape[1], 3), generator=g,
                        device=dev)
        jit = torch.rand((batch["rays_o"].shape[1],), generator=g,
                         device=dev)
        stepped = []
        for route in ("kernel", "plain", "kernel"):
            twin = make_network(replace(F.TRAIN_CFG, fused=True,
                                        compute_dtype=name),
                                net.params_tree(), device=dev,
                                trainable=True)
            if route == "plain":
                twin.forward = functools.partial(type(twin).forward, twin,
                                                 plain=True)
            tr = Trainer(opt, twin, mute=True)
            tr.renderer_state, tr.global_step = t_state, steps
            zero()
            _, loss = tr.train_step(batch, bg=bg, perturb=jit)
            stepped.append((float(loss), launched()[key],
                            [w.detach().clone() for w in twin.param_list()],
                            [w.grad.clone() for w in twin.param_list()]))
            del tr, twin
        (l_k, n_k, p_k, g_k), (l_p, n_p, p_p, g_p) = stepped[:2]
        tol = TOL_K3_STEP[name]
        rel = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(g_k, g_p)]
        moved = [float((a - b).abs().max()) for a, b in zip(p_k, p_p)]
        apart = [(a - b).abs() > 1e-6 for a, b in zip(p_k, p_p)]
        n_apart = [int(m.sum()) for m in apart]
        # an update apart only where the gradient is within `grad` of zero
        flips = all(bool((g[m].abs() <= tol["grad"] * g.abs().max()).all())
                    for g, m in zip(g_p, apart))
        twice = all(torch.equal(a, b) for a, b in zip(g_k, stepped[2][3]))
        print(f"train fused {name}, one step through K3 vs its plain "
              f"forward: loss {l_k:.8f} / {l_p:.8f} (rel "
              f"{abs(l_k - l_p) / abs(l_p):.3e}); K3 launches {n_k} / "
              f"{n_p}; gradient max |diff| / max |grad| per tensor "
              f"{['%.2e' % v for v in rel]}; updated parameters max |diff| "
              f"{['%.2e' % v for v in moved]}, entries apart by > 1e-6 "
              f"{n_apart} (each where the gradient is within the gradient "
              f"bound of zero: {flips}) (pyramid grids, hash table, sigma "
              f"net, color net; bounds: loss {tol['loss']}, gradients "
              f"{tol['grad']}, entries apart {tol['apart']}); the kernel "
              f"route twice equal: {twice}")
        check(n_k >= 1 and n_p == 0, "the step routes' K3 launches")
        check(twice, "the K3 route's gradients differ between two runs")
        check(abs(l_k - l_p) <= tol["loss"] * abs(l_p)
              and max(rel) <= tol["grad"] and flips
              and sum(n_apart) <= tol["apart"],
              f"the fused {name} step through K3 and through its plain "
              "forward differ by more than the stated tolerance")
        train[name] = dict(steps=steps, s_per_step=t_train / steps,
                           launches=n, loss_first=first, loss_last=last,
                           folds={f: folds.count(f) for f in set(folds)},
                           step_loss_rel=abs(l_k - l_p) / abs(l_p),
                           step_grad_rel=max(rel),
                           step_max_moved=max(moved),
                           step_entries_apart=sum(n_apart))
        del net, t_state, trainer, stepped, p_k, g_k, p_p, g_p
        torch.cuda.empty_cache()
    del dataset
    return dict(k3=k3, k1=k1, backward=backward, frames=framed, train=train,
                k3_launches=k3_frames + train["float32"]["launches"][
                    "K3 f32"], k3_launches_frames=k3_frames,
                k1_launches=k1_frames,
                k3_bf16_train=train["bfloat16"]["launches"]["K3"])


def f32_only():
    """`python3 chip_smoke.py --f32`: phase 34 alone, on the committed
    teacher refreshed 4x, with the bf16 frames it compares with rendered
    first. Not part of the smoke."""
    import torch
    check(torch.cuda.is_available(), "no CUDA card")
    sys.path.insert(0, str(ROOT))
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch.ops.hopper import (fold_build,
                                                           points_mlp,
                                                           sigma_color)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    with Phase("build"):
        mods = (points_mlp, sigma_color, fold_build)
        with ThreadPoolExecutor(len(mods)) as pool:
            list(pool.map(lambda m: m.build(), mods))
        for m in mods:
            for line in m.BUILD_LOG.splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling entry" in line:
                    print("  ptxas:", line.strip())
    with Phase("teacher"), torch.inference_mode():
        teacher, stored = F.load_teacher_net(dev)
        state = F.refresh(teacher, stored)
        views = spheres_views(dev)
        student = F.load_student_net(dev)
        k1_pts = k1_points(torch, student.cfg, dev)
        k3_pts = k3_points(torch, teacher, state, views)
        bf16_psnr = {}
        for mode, nets in (("fast", {"teacher": teacher}),
                           ("guided", {"teacher": teacher}),
                           ("baked_h160_ak8", {"student_h160": student})):
            ps = []
            for o, d, gt in views:
                img = F.render(mode, nets, state, o, d)["image"]
                pred = img.cpu().numpy().reshape(gt.shape).astype(np.float64)
                ps.append(float(-10.0 * np.log10(max(
                    np.mean((pred - gt) ** 2), 1e-10))))
            bf16_psnr[mode] = float(np.mean(ps))
        print(f"bf16 frames' mean PSNR: {bf16_psnr}")
    with Phase("f32"):
        st = f32_phase(torch, teacher, state, views, k1_pts, k3_pts,
                       bf16_psnr, smi)
    print("f32: " + json.dumps(st))
    print(f"total {time.perf_counter() - t_start:.2f} s; {smi}", flush=True)


def distill_phase(torch, teacher, state, smi):
    """The distillation phase (see the module docstring): the K3 launches
    of each step, the losses, the pkl round trip, the served student
    through K1 against the trained unfused chain, pose 0 in
    baked_h160_ak8. Returns its numbers; `k3_launches` and
    `k1_launches` are the counts of the path (the comparison's K1
    launches are not among them)."""
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch.assets import (load_student,
                                                       params_from_jax,
                                                       save_student)
    from nerfsafetyvalidation_tpu_torch.data.synthetic import (camera_rays,
                                                               trace_scene)
    from nerfsafetyvalidation_tpu_torch.models import make_network
    from nerfsafetyvalidation_tpu_torch.models.bake import (
        _occupied_cells, distill, finetune_render, student_config)
    from nerfsafetyvalidation_tpu_torch.ops.hopper import (points_mlp,
                                                           sigma_color)
    from nerfsafetyvalidation_tpu_torch.train_flagship import ClipCount
    dev = state.density_bitfield.device
    hidden, K = DISTILL_HIDDEN, 16
    counted = ClipCount(teacher)
    scfg = student_config(teacher.cfg, multires=12, hidden_dim=hidden,
                          num_layers=6)
    gen = torch.Generator(device=dev).manual_seed(DISTILL_SEED)
    rec = {"distill": ([], []), "finetune": ([], [])}
    last = [0]

    def hook(phase):
        def on_step(i, loss):
            losses, k3 = rec[phase]
            losses.append(loss)
            k3.append(sigma_color.LAUNCHES - last[0])
            last[0] = sigma_color.LAUNCHES
        return on_step
    sigma_color.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    student, sparams, d_loss = distill(counted, state, steps=DISTILL_STEPS,
                                       cfg=scfg, generator=gen,
                                       on_step=hook("distill"))
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    pool_o, pool_d = F.ray_pool(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sparams, f_loss = finetune_render(student, sparams, counted, state,
                                      pool_o, pool_d, steps=FT_STEPS, K=K,
                                      generator=gen,
                                      on_step=hook("finetune"))
    torch.cuda.synchronize()
    t_f = time.perf_counter() - t0
    k3_launches = sigma_color.LAUNCHES
    clip = counted.counts()
    out = {"s_per_step": {"distill": t_d / DISTILL_STEPS,
                          "finetune": t_f / FT_STEPS},
           "final_loss": {"distill": d_loss, "finetune": f_loss},
           "k3_clipping": clip}
    for phase, (losses, k3) in rec.items():
        lv = torch.stack(losses).cpu().numpy()
        first = float(lv[:LOSS_WINDOW].mean())
        lastw = float(lv[-LOSS_WINDOW:].mean())
        out[phase] = dict(steps=len(lv), loss_first=first, loss_last=lastw,
                          k3_launches=sum(k3),
                          k3_per_step_min=min(k3, default=0))
        print(f"distill phase {phase}: {len(lv)} steps, loss mean of the "
              f"first {LOSS_WINDOW} {first:.6f}, of the last "
              f"{LOSS_WINDOW} {lastw:.6f}; K3 launches {sum(k3)} (at "
              f"least {min(k3, default=0)} a step)")
        check(bool(np.isfinite(lv).all()), f"the {phase} loss is not "
              "finite")
        check(lastw < first, f"the {phase} loss did not fall")
        check(len(k3) == (DISTILL_STEPS if phase == "distill"
                          else FT_STEPS) and min(k3) >= 1,
              f"K3 did not launch in every {phase} step")
    # the pkl round trip
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "student.pkl"
        save_student(path, sparams, (DISTILL_STEPS, FT_STEPS), K, hidden, 6)
        back = params_from_jax(load_student(path), dev)
    check(all(torch.equal(a, b) for k in ("sigma_net", "color_net")
              for a, b in zip(back[k], sparams[k])),
          "the student pkl does not reload bit-equal")
    served = make_network(F.student_cfg(hidden), back, device=dev)
    plain = make_network(scfg, back, device=dev)
    with torch.inference_mode():
        # the served student through K1 against the trained unfused chain,
        # on K1_ROWS points drawn as the distillation draws them
        g2 = torch.Generator(device=dev).manual_seed(DISTILL_SEED + 1)
        cells = _occupied_cells(state, teacher.cfg.grid_size)
        half = K1_ROWS // 2
        ci = torch.randint(0, cells.shape[0], (half,), generator=g2,
                           device=dev)
        x = torch.cat([cells[ci] + (torch.rand((half, 3), generator=g2,
                                               device=dev) * 3.0 - 1.5)
                       / teacher.cfg.grid_size,
                       torch.rand((K1_ROWS - half, 3), generator=g2,
                                  device=dev) * 2.0 - 1.0]).clamp(-1, 1)
        d = torch.randn((K1_ROWS, 3), generator=g2, device=dev)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        got = served(x, d)
        want = plain(x, d)
        n_hi = int((want[0] > E15).sum())
        err = compare(torch, "K1, the distilled student, vs its trained "
                      "unfused chain", got, want, TOL_K1)
        # pose 0 at 800^2 in baked_h160_ak8, K1 counted
        pose = F.holdout_poses()[0]
        o_np, d_np = camera_rays(pose, F.intrinsics(F.RES), F.RES, F.RES)
        rgb, alpha, _ = trace_scene(o_np, d_np, scene="spheres")
        gt = rgb * alpha[..., None] + (1.0 - alpha[..., None])
        o, dd = F.pose_rays(pose, dev, F.RES)
        points_mlp.LAUNCHES_BY_WIDTH.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = F.render("baked_h160_ak8", {f"student_h{hidden}": served},
                       state, o, dd, F.RES)["image"]
        torch.cuda.synchronize()
        t_frame = time.perf_counter() - t0
        k1_launches = points_mlp.LAUNCHES_BY_WIDTH.get(hidden, 0)
        check(img.shape == (F.RES * F.RES, 3)
              and bool(torch.isfinite(img).all()),
              "the distilled student's frame is not finite [N, 3]")
        pred = img.cpu().numpy().reshape(gt.shape).astype(np.float64)
        p = float(-10.0 * np.log10(max(np.mean((pred - gt) ** 2), 1e-10)))
    check(k1_launches > 0, "K1 did not launch in the distilled student's "
          "frame")
    out.update(k3_launches=k3_launches, k1_launches=k1_launches,
               k1_max_abs_err=err, k1_rows_s0_gt_15=n_hi, psnr_pose0=p,
               frame_s=t_frame)
    print(f"distill: {DISTILL_STEPS} distill steps of 32768 points "
          f"{t_d / DISTILL_STEPS:.5f} s/step, {FT_STEPS} fine-tune steps of "
          f"8192 rays x {K} {t_f / FT_STEPS:.5f} s/step; final losses "
          f"{d_loss:.6f} / {f_loss:.6f}; K3 launches {k3_launches}; K3 rows "
          f"{clip['rows']}, s0 >= 15 on {clip['s0_ge_15']} "
          f"({clip['share_ge_15']:.3e}), s0 <= -15 on {clip['s0_le_-15']} "
          f"({clip['share_le_-15']:.3e}); K1 vs the unfused chain max abs "
          f"{err:.3e} ({n_hi} rows with s0 > 15); baked_h160_ak8 pose 0 at "
          f"{F.RES}x{F.RES}: PSNR {p:.3f} dB (no bar: a cut schedule), "
          f"{t_frame:.3f} s, K1 launches {k1_launches}; {smi}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The training CLI's other command lines (phase 11d, `--cli-options` alone):
# main_nerf on the phase-11c spheres directory at the CLI's default widths
# but --bound 1 --scale 1 (the scene's box), each run's command line below.
# The first trains the FF net on the tiled grid with the error map, then
# `--test` renders the test split in fast (with the 256^3 mesh), guided
# and scout; --tcnn trains the biased net, which never calls a kernel;
# --bg_radius 4 (the cameras sit 2.4 from the centre, inside the sphere)
# trains the background net through the staged uniform render; --ff
# --encoding None runs the color net alone through K4.
CLI_RUNS = {
    "-O --ff --encoding tiledgrid --error_map":
        ["-O", "--ff", "--encoding", "tiledgrid", "--error_map", "--iters",
         "96"],
    "--tcnn -O": ["--tcnn", "-O", "--iters", "96"],
    "--bg_radius 4": ["--bg_radius", "4", "--iters", "8"],
    "--ff --encoding None": ["--ff", "--encoding", "None", "--iters", "8"],
}
CLI_MODES = ("fast", "guided", "scout")
MESH_RES, MESH_THRESHOLD, MESH_BLOCK = 256, 10, 128
LOSS_STEPS = 16       # the first and last steps whose mean losses compare


def cli_options_phase(torch, fused_mlp, main_nerf, data_dir, root, smi):
    """Phase 11d (see the module docstring). Returns its numbers; its K4
    launch counts under 'k4'."""
    from nerfsafetyvalidation_tpu_torch.cli import apply_O_flag, build_parser
    from nerfsafetyvalidation_tpu_torch.config import network_config_from_opt
    from nerfsafetyvalidation_tpu_torch.data.provider import NeRFDataset
    from nerfsafetyvalidation_tpu_torch.models import make_network
    from nerfsafetyvalidation_tpu_torch.train.trainer import Trainer
    from nerfsafetyvalidation_tpu_torch.utils.seeding import seed_everything

    def k4():
        return (fused_mlp.LAUNCHES, fused_mlp.LAUNCHES_F32,
                fused_mlp.PLAIN_CALLS)

    # K4's counts at each reset since the run began: a run's count is
    # their sum and what the counters hold now
    segments = []

    def zero():
        segments.append(k4())
        fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_F32 = 0
        fused_mlp.PLAIN_CALLS = 0

    def start_run():
        zero()
        segments.clear()

    def run_total():
        return tuple(map(sum, zip(k4(), *segments)))

    def argv(name, *more):
        return [data_dir, "--workspace", str(Path(root) / f"cli{name}"),
                "--bound", "1", "--scale", "1", "--seed", "0",
                *CLI_RUNS[name], *more]

    # per frame: K4 launches, plain calls, seconds, PSNR; per mesh: stats
    frames, meshes = [], []
    render_view, save_mesh = Trainer._render_test_view, Trainer.save_mesh

    def recorded_view(self, net, data, mode):
        zero()
        t0 = time.perf_counter()
        out = render_view(self, net, data, mode)
        torch.cuda.synchronize()
        n, n32, plain = k4()
        img = data["images"].reshape(-1, data["images"].shape[-1])
        pred = out["image"].reshape(-1, 3)
        gt = img[:, :3] * img[:, 3:] + (1 - img[:, 3:])
        mse = float(torch.mean((pred - gt) ** 2))
        frames.append(dict(mode=mode, k4=n, k4_f32=n32, plain=plain,
                           s=time.perf_counter() - t0,
                           psnr=-10.0 * np.log10(mse),
                           finite=bool(torch.isfinite(pred).all())))
        return out

    def recorded_mesh(self, *a, **kw):
        zero()
        path, stats = save_mesh(self, *a, **kw)
        n, n32, plain = k4()
        meshes.append(dict(stats, k4=n, k4_f32=n32, plain=plain, path=path,
                           written=os.path.getsize(path) > 0))
        return path, stats

    def train(name):
        marks = []
        start_run()
        t0 = time.perf_counter()
        tr = main_nerf.main(argv(name), device="cuda",
                            on_epoch=lambda t: marks.append(run_total()))
        torch.cuda.synchronize()
        steps, losses = tr.global_step, np.asarray(tr.stats["step_loss"])
        st = dict(steps=steps, s_per_step=sum(tr.epoch_times) / steps,
                  s_all=time.perf_counter() - t0, k4_train=marks[-1][0],
                  k4_f32=run_total()[1], net=type(tr.net).__name__,
                  first=float(losses[:LOSS_STEPS].mean()),
                  last=float(losses[-LOSS_STEPS:].mean()),
                  finite=bool(np.isfinite(losses).all()),
                  psnr_eval=tr.stats["results"][-1])
        print(f"main_nerf {name}: {st['net']} ({tr.net.cfg.encoding}, "
              f"{tr.net.cfg.compute_dtype}), {steps} steps, "
              f"{st['s_per_step']:.5f} s/step, {st['s_all']:.2f} s in all; "
              f"K4 {st['k4_train']} launches in training "
              f"({st['k4_train'] / steps:.2f} a step), K4 f32 "
              f"{st['k4_f32']}; mean loss of the first {LOSS_STEPS} steps "
              f"{st['first']:.6f}, of the last {st['last']:.6f}; test-split "
              f"evaluate PSNR {st['psnr_eval']:.3f} dB; {smi}", flush=True)
        check(st["finite"], f"main_nerf {name}: a loss is not finite")
        check(st["k4_f32"] == 0, f"main_nerf {name} launched K4 f32")
        return tr, st

    out = {}
    Trainer._render_test_view, Trainer.save_mesh = recorded_view, \
        recorded_mesh
    try:
        # ---- -O --ff --encoding tiledgrid --error_map, then --test ------
        name = "-O --ff --encoding tiledgrid --error_map"
        tr, st = train(name)
        check(st["net"] == "NeRFNetworkFF"
              and tr.net.grid_spec.gridtype == "tiled",
              f"main_nerf {name} did not build the FF net on a tiled grid")
        check(st["k4_train"] >= 2 * st["steps"], f"main_nerf {name} "
              f"launched K4 {st['k4_train']} times in {st['steps']} steps")
        check(st["last"] < st["first"], f"main_nerf {name}: the losses did "
              "not fall")
        emap = tr.error_map
        moved = (emap != 1.0).sum(axis=1)
        st["error_map"] = dict(views=int(emap.shape[0]),
                               cells=int(emap.shape[1]),
                               moved=int(moved.sum()),
                               views_moved=int((moved > 0).sum()))
        print(f"main_nerf {name}: error map {emap.shape}, "
              f"{st['error_map']['moved']} cells moved from 1 in "
              f"{st['error_map']['views_moved']} views, values "
              f"{float(emap.min()):.3e} .. {float(emap.max()):.3e}")
        check(st["error_map"]["views_moved"] == emap.shape[0]
              and (emap[emap != 1.0] < 1.0).mean() > 0.5,
              f"main_nerf {name}: the error map kept its ones where rays "
              "were drawn")
        del tr
        frames.clear()
        tr = main_nerf.main(argv(name, "--test", "--render_mode", "fast"),
                            device="cuda")
        st["psnr_staged"] = tr.stats["results"][-1]
        loader = NeRFDataset(tr.opt, type="test",
                             device="cuda").dataloader()
        for mode in CLI_MODES[1:]:
            tr.opt.render_mode = mode
            tr.test(loader, write_video=True)
        st["frames"] = {}
        for mode in CLI_MODES:
            fs = [f for f in frames if f["mode"] == mode]
            st["frames"][mode] = dict(
                n=len(fs), k4=[f["k4"] for f in fs],
                s_per_frame=sum(f["s"] for f in fs) / max(len(fs), 1),
                psnr=float(np.mean([f["psnr"] for f in fs])))
            print(f"main_nerf {name} --test --render_mode {mode}: "
                  f"{len(fs)} frames at 200x200, "
                  f"{st['frames'][mode]['s_per_frame']:.4f} s/frame, K4 "
                  f"launches a frame {st['frames'][mode]['k4']}, PSNR "
                  f"{st['frames'][mode]['psnr']:.3f} dB (staged "
                  f"{st['psnr_staged']:.3f} dB; no bar); {smi}")
            check(len(fs) == 4 and all(f["k4"] > 0 and f["plain"] == 0
                                       and f["k4_f32"] == 0
                                       and f["finite"] for f in fs),
                  f"--test --render_mode {mode}: a frame did not launch K4"
                  " (or ran its plain version, or is not finite)")
        check(len(meshes) == 1, "--test wrote no mesh")
        mesh = st["mesh"] = meshes.pop()
        print(f"main_nerf {name} --test mesh at {MESH_RES}^3: "
              f"{mesh['vertices']} vertices, {mesh['faces']} faces; probe "
              f"{mesh['probe_s']:.3f} s ({mesh['k4']} K4 launches), "
              f"iso-surface {mesh['surface_s']:.3f} s, file "
              f"{mesh['file_s']:.3f} s; {smi}")
        check(mesh["written"] and mesh["faces"] > 0, "the mesh is empty")
        check(mesh["k4"] == (MESH_RES // MESH_BLOCK) ** 3
              and mesh["plain"] == 0 and mesh["k4_f32"] == 0,
              f"the mesh probe launched K4 {mesh['k4']} times, not "
              f"{(MESH_RES // MESH_BLOCK) ** 3}")
        # one probe block (the first 128^3 points) through K4 and the plain
        # chain: the sigma net's [N, 16] outputs
        g = np.linspace(-1.0, 1.0, MESH_RES)[:MESH_BLOCK]
        pts = torch.as_tensor(np.stack([a.reshape(-1) for a in np.meshgrid(
            g, g, g, indexing="ij")], -1).astype(np.float32), device="cuda")
        with torch.no_grad():
            h = tr.net.encode_pos(pts)
            ws = list(tr.net.sigma_net)
            got = fused_mlp.fused_mlp(h, ws, tr.net.compute_dtype)
            want = fused_mlp.fused_mlp_plain(h, ws, tr.net.compute_dtype)
        rel = (got - want).abs() / want.abs().clamp(min=1.0)
        st["block"] = dict(rows=int(pts.shape[0]),
                           max_rel=float(rel.max()),
                           mean_rel=float(rel.mean()),
                           max_abs=float((got - want).abs().max()))
        print(f"mesh probe block of {pts.shape[0]} rows, sigma net through "
              f"K4 vs plain: max rel {st['block']['max_rel']:.3e} mean "
              f"{st['block']['mean_rel']:.3e}")
        t_max, t_mean = TOL_K4["sigma"]
        check(st["block"]["max_rel"] <= t_max
              and st["block"]["mean_rel"] <= t_mean,
              "the mesh probe's K4 block disagrees with the plain chain")
        out[name] = st
        del tr, h, got, want, pts
        torch.cuda.empty_cache()

        # ---- --tcnn -O, then --test: no kernel ---------------------------
        name = "--tcnn -O"
        tr, st = train(name)
        check(st["net"] == "NeRFNetworkTCNN", f"main_nerf {name} did not "
              "build NeRFNetworkTCNN")
        check(st["k4_train"] == 0, f"main_nerf {name} launched K4")
        check(st["last"] < st["first"], f"main_nerf {name}: the losses did "
              "not fall")
        net2 = make_network(tr.net.cfg, None, device="cuda", opt=tr.opt,
                            trainable=True)
        tr2 = Trainer(tr.opt, net2, ema_decay=0.95,
                      workspace=str(Path(root) / f"cli{name}"),
                      use_checkpoint="latest", mute=True)
        st["reloaded"] = all(torch.equal(a, b) for a, b in zip(
            net2.param_list() + tr2.ema_params,
            tr.net.param_list() + tr.ema_params, strict=True))
        check(st["reloaded"], f"main_nerf {name}: the checkpoint does not "
              "reload bit-equal")
        del tr, tr2, net2
        start_run()
        tr = main_nerf.main(argv(name, "--test"), device="cuda")
        st["k4_test"] = run_total()[0]
        mesh = st["mesh"] = meshes.pop()
        print(f"main_nerf {name}: checkpoint reloaded bit-equal "
              f"{st['reloaded']}; --test K4 launches {st['k4_test']}; mesh "
              f"{mesh['vertices']} vertices, {mesh['faces']} faces, probe "
              f"{mesh['probe_s']:.3f} s, iso-surface {mesh['surface_s']:.3f}"
              f" s, file {mesh['file_s']:.3f} s; {smi}")
        check(st["k4_test"] == 0 and mesh["written"],
              f"main_nerf {name} --test launched K4 or wrote no mesh")
        out[name] = st
        del tr
        torch.cuda.empty_cache()

        # ---- --bg_radius 4: the 2-D table trains --------------------------
        name = "--bg_radius 4"
        tr, st = train(name)
        opt = apply_O_flag(build_parser("train").parse_args(argv(name)),
                           "train")
        init = make_network(network_config_from_opt(opt), None,
                            device="cuda", opt=opt,
                            generator=seed_everything(opt.seed, "cuda"))
        diff = (tr.net.embeddings_bg.detach() - init.embeddings_bg).abs()
        st["bg_rows_moved"] = int((diff.amax(dim=1) > 0).sum())
        st["bg_max_move"] = float(diff.max())
        print(f"main_nerf {name}: {st['bg_rows_moved']} of "
              f"{diff.shape[0]} background-table rows moved (max "
              f"{st['bg_max_move']:.3e})")
        check(st["bg_rows_moved"] > 0, f"main_nerf {name}: the background "
              "table did not move")
        out[name] = st
        del tr, init
        torch.cuda.empty_cache()

        # ---- --ff --encoding None: the color net through K4 -------------
        name = "--ff --encoding None"
        tr, st = train(name)
        check(st["net"] == "NeRFNetworkFF" and tr.net.grid_spec is None,
              f"main_nerf {name} did not build the FF net without a grid")
        check(st["k4_train"] >= st["steps"], f"main_nerf {name} launched "
              f"K4 {st['k4_train']} times in {st['steps']} steps")
        out[name] = st
        del tr
        torch.cuda.empty_cache()
    finally:
        Trainer._render_test_view, Trainer.save_mesh = render_view, \
            save_mesh
    tiled = out["-O --ff --encoding tiledgrid --error_map"]
    out["k4"] = {"O_ff_tiledgrid_train": tiled["k4_train"],
                 **{f"test_{m}": sum(tiled["frames"][m]["k4"])
                    for m in CLI_MODES},
                 "mesh_probe": tiled["mesh"]["k4"],
                 "tcnn": out["--tcnn -O"]["k4_train"]
                 + out["--tcnn -O"]["k4_test"],
                 "ff_none_train": out["--ff --encoding None"]["k4_train"]}
    return out


def cli_options_only():
    """`python3 chip_smoke.py --cli-options`: phase 11d alone, on the
    spheres directory, printing its numbers. Not part of the smoke."""
    import torch
    check(torch.cuda.is_available(), "no CUDA card")
    sys.path.insert(0, str(ROOT))
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch import main_nerf
    from nerfsafetyvalidation_tpu_torch.data.synthetic import write_dataset
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        data_dir = str(Path(root) / "spheres")
        write_dataset(data_dir, F.train_splits())
        with Phase("build"):
            fused_mlp.build()
        with Phase("cli options"):
            st = cli_options_phase(torch, fused_mlp, main_nerf, data_dir,
                                   root, smi)
        print("cli_options: " + json.dumps(st))
    print(f"total {time.perf_counter() - t_start:.2f} s; {smi}", flush=True)


def distill_only():
    """`python3 chip_smoke.py --distill`: the distillation phase alone, on
    the committed teacher refreshed 4x. Not part of the smoke."""
    import torch
    check(torch.cuda.is_available(), "no CUDA card")
    sys.path.insert(0, str(ROOT))
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch.ops.hopper import (points_mlp,
                                                           sigma_color)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    with Phase("build"):
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda m: m.build(), (points_mlp, sigma_color)))
    with Phase("teacher"), torch.inference_mode():
        teacher, stored = F.load_teacher_net(torch.device("cuda", 0))
        state = F.refresh(teacher, stored)
    with Phase("distill"):
        st = distill_phase(torch, teacher, state, smi)
    print("distill: " + json.dumps(st))
    print(f"total {time.perf_counter() - t_start:.2f} s; {smi}", flush=True)


def closed_loop_intrinsics():
    """`python3 chip_smoke.py --closed-loop-intrinsics`: the validate
    --closed_loop phase (20) twice on the same net, its intrinsics read
    from the 200^2 training directory and from the 800^2 test view
    (VALIDATE_RES), printing each run's numbers. Not part of the smoke."""
    import torch
    check(torch.cuda.is_available(), "no CUDA card")
    sys.path.insert(0, str(ROOT))
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch import main_nerf
    from nerfsafetyvalidation_tpu_torch import validate as validate_cli
    from nerfsafetyvalidation_tpu_torch.data.synthetic import (
        generate_dataset, write_dataset)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        dirs = {"200^2 training set": str(Path(root) / "spheres"),
                f"{VALIDATE_RES}^2 test view": str(
                    Path(root) / f"spheres{VALIDATE_RES}")}
        write_dataset(dirs["200^2 training set"], F.train_splits())
        write_dataset(dirs[f"{VALIDATE_RES}^2 test view"], generate_dataset(
            n_train=1, n_val=1, n_test=1, H=VALIDATE_RES, W=VALIDATE_RES))
        ws = str(Path(root) / "ws_unfused")
        main_nerf.main([dirs["200^2 training set"], "--workspace", ws,
                        "--bound", "1", "--scale", "1", "--seed", "0",
                        *VALIDATE_UNFUSED], device="cuda")
        ckpt = sorted(Path(ws, "checkpoints").glob("ngp_ep*.ckpt"))[-1]
        for name, d in dirs.items():
            with Phase(f"validate --closed_loop, intrinsics of the {name}"):
                st = validate_phase(torch, validate_cli, d, ["--closed_loop"],
                                    "Monte Carlo", 4, ckpt, smi)
            print(f"intrinsics of the {name}: estimate off the truth by "
                  f"{st['est_pos_err_m']:.5f} m on average, sigma_d "
                  f"{st['sigma_d']}; {smi}", flush=True)


def sequential_only():
    """`python3 chip_smoke.py --sequential`: the sequential phases alone
    (sequential MC, sequential CEM, simulate) on a freshly trained
    VALIDATE_UNFUSED net, printing their numbers. Not part of the smoke."""
    import torch
    check(torch.cuda.is_available(), "no CUDA card")
    sys.path.insert(0, str(ROOT))
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch import main_nerf
    from nerfsafetyvalidation_tpu_torch import validate as validate_cli
    from nerfsafetyvalidation_tpu_torch.data.synthetic import (
        generate_dataset, write_dataset)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        train_dir = str(Path(root) / "spheres")
        val_dir = str(Path(root) / f"spheres{VALIDATE_RES}")
        write_dataset(train_dir, F.train_splits())
        write_dataset(val_dir, generate_dataset(
            n_train=1, n_val=1, n_test=1, H=VALIDATE_RES, W=VALIDATE_RES))
        ws = str(Path(root) / "ws_unfused")
        with Phase("validate nets"):
            main_nerf.main([train_dir, "--workspace", ws, "--bound", "1",
                            "--scale", "1", "--seed", "0",
                            *VALIDATE_UNFUSED], device="cuda")
        ckpt = sorted(Path(ws, "checkpoints").glob("ngp_ep*.ckpt"))[-1]
        st = sequential_phase(torch, validate_cli, val_dir, ckpt, smi)
        with Phase("simulate"):
            st["simulate"] = simulate_phase(torch, val_dir, ckpt,
                                            st["MC"]["path"], smi)
        print("sequential: " + json.dumps(st))


def laplace_only():
    """`python3 chip_smoke.py --laplace`: the Bayesian-Laplace phases alone
    (25-28) on freshly trained `main_nerf -O --ff` and VALIDATE_UNFUSED
    nets, printing their numbers and the grouped kernel's. Not part of the
    smoke."""
    import torch
    check(torch.cuda.is_available(), "no CUDA card")
    sys.path.insert(0, str(ROOT))
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch import main_nerf
    from nerfsafetyvalidation_tpu_torch import validate as validate_cli
    from nerfsafetyvalidation_tpu_torch.data.synthetic import (
        generate_dataset, write_dataset)
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        train_dir = str(Path(root) / "spheres")
        val_dir = str(Path(root) / f"spheres{VALIDATE_RES}")
        write_dataset(train_dir, F.train_splits())
        write_dataset(val_dir, generate_dataset(
            n_train=1, n_val=1, n_test=1, H=VALIDATE_RES, W=VALIDATE_RES))
        with Phase("build"):
            fused_mlp.build()
        ckpts = {}
        for name, flags in (("ff", MAIN_NERF_RUNS[0][1]),
                            ("unfused", VALIDATE_UNFUSED)):
            with Phase(f"main_nerf {' '.join(flags)}"):
                ws = str(Path(root) / f"ws_{name}")
                main_nerf.main([train_dir, "--workspace", ws, "--bound",
                                "1", "--scale", "1", "--seed", "0", *flags],
                               device="cuda")
            ckpts[name] = sorted(Path(ws, "checkpoints").glob(
                "ngp_ep*.ckpt"))[-1]
        st = laplace_phases(torch, fused_mlp, validate_cli, root,
                            ckpts["ff"], ckpts["unfused"], val_dir, smi)
        print("laplace: " + json.dumps(st))


def fast_render_only():
    """`python3 chip_smoke.py --fast-render`: phases 29-32 alone on freshly
    trained `main_nerf -O --ff` and VALIDATE_UNFUSED nets (without phase
    19's and 22's directories: the --fast_render phases plan afresh, and
    the replay reads phase 31's Monte Carlo CSV), printing their numbers.
    Not part of the smoke."""
    import torch
    check(torch.cuda.is_available(), "no CUDA card")
    sys.path.insert(0, str(ROOT))
    from nerfsafetyvalidation_tpu_torch import flagship as F
    from nerfsafetyvalidation_tpu_torch import main_nerf
    from nerfsafetyvalidation_tpu_torch import validate as validate_cli
    from nerfsafetyvalidation_tpu_torch.data.synthetic import (
        generate_dataset, write_dataset)
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        train_dir = str(Path(root) / "spheres")
        val_dir = str(Path(root) / f"spheres{VALIDATE_RES}")
        write_dataset(train_dir, F.train_splits())
        write_dataset(val_dir, generate_dataset(
            n_train=1, n_val=1, n_test=1, H=VALIDATE_RES, W=VALIDATE_RES))
        with Phase("build"):
            fused_mlp.build()
        ckpts = {}
        for name, flags in (("ff", MAIN_NERF_RUNS[0][1]),
                            ("unfused", VALIDATE_UNFUSED)):
            with Phase(f"main_nerf {' '.join(flags)}"):
                ws = str(Path(root) / f"ws_{name}")
                main_nerf.main([train_dir, "--workspace", ws, "--bound",
                                "1", "--scale", "1", "--seed", "0", *flags],
                               device="cuda")
            ckpts[name] = sorted(Path(ws, "checkpoints").glob(
                "ngp_ep*.ckpt"))[-1]
        t0 = time.perf_counter()
        st = fast_render_phases(torch, validate_cli, ckpts["ff"],
                                ckpts["unfused"], val_dir, None, None, root,
                                smi)
        print("fast_render: " + json.dumps(st))
        print(f"phases 29-32 {time.perf_counter() - t0:.2f} s; total "
              f"{time.perf_counter() - t_start:.2f} s; {smi}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--closed-loop-intrinsics"]:
        closed_loop_intrinsics()
    elif sys.argv[1:] == ["--sequential"]:
        sequential_only()
    elif sys.argv[1:] == ["--laplace"]:
        laplace_only()
    elif sys.argv[1:] == ["--fast-render"]:
        fast_render_only()
    elif sys.argv[1:] == ["--distill"]:
        distill_only()
    elif sys.argv[1:] == ["--cli-options"]:
        cli_options_only()
    elif sys.argv[1:] == ["--f32"]:
        f32_only()
    else:
        main()
