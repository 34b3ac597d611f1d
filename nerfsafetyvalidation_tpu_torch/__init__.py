"""PyTorch / CUDA port of `nerfsafetyvalidation_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference. This package imports
`torch` and numpy only, never `jax` and nothing of the JAX package. Every
TPU kernel on a ported path is a kernel written by hand for Hopper under
`csrc/`, bound by `ops/hopper/`; on a CPU tensor its wrapper runs the plain
PyTorch version instead, which is what the tests use.

Ported so far: the baked-student guided frame (`models.renderer.
render_frame_guided` in scout mode with natural tile order), with the
points-in MLP chain as the CUDA kernel `ops.hopper.points_mlp`; the
mip-fold teacher's marched frame (`render_frame_fast`) and its guided
frame with the march prepass, with the field chain as the CUDA kernel
`ops.hopper.sigma_color`; the occupancy refresh (`update_extra_state`);
and the hash-grid reference backbone (`models.network.NeRFNetwork` with the
corner-layout encode of `ops.hash_encoding`) in the marched frame, with its
MLPs as the CUDA kernel `ops.hopper.fused_mlp`; and the teacher's training
(`train.trainer.Trainer`, `flagship.train_flagship`), whose fold table is
built by the CUDA kernel `ops.hopper.fold_build` forward and backward; the
student's chain from a precomputed encoding (`ops.hopper.points_mlp.
fused_sigma_color_deep`), and the gather probe (`scripts.bench_gather`)
with its row gathers as the CUDA kernels of `ops.hopper.gather`; and the
uniform-sampling render the reference's entry points observe a trained
NeRF with (`models.renderer.run`, staged `render`, `render_tiles`,
`ops.compositing`, `ops.sample_pdf`) and the trainer's evaluation
through it, with K4 in float32 (the JAX package's default compute dtype)
as a second CUDA kernel of `ops.hopper.fused_mlp`; and the batched rollout
engines (`validation.batched`: Monte Carlo and cross-entropy populations
stepped together, with `nav` dynamics, `validation.utils.sdf`, and each
observation rendered through the frames above and their kernels),
measured by `bench_rollouts`; and the validate CLI's population modes
(`validate`: the planner of `nav.planner` over A* in `csrc/astar.cpp`,
`validation.simulators.NerfSimulator.reset`, the open-loop engines on the
planned actions and the closed-loop engine of `validation.closed_loop`);
and validate's sequential path, its UQ methods, `--fast_render` (the
cell-layout encode and `models.renderer.render_grid_staged`) and `--r`
(`validation.replay` on `validation.simulators.BlenderSimulator`).
"""
