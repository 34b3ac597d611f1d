"""bench.py's reference-backbone schedule (`_train_ref_backbone`,
bench.py:354-426) trained by the JAX package on the CPU, and scored in the
port's `ref_backbone` frame on the four held-out poses at 800x800: where
does the JAX package's own training land beside `bench_assets/refbb.ckpt`
(that schedule's run on the TPU) and beside the port's runs on the card
(`train_flagship.py --net ref`)? Not a test: a script, run from the repo's
root (about 11 minutes a seed on a CPU host for the whole schedule, 0.63 s
a step):

    PYTHONPATH=. python tests/ref_schedule_jax_cpu.py [--iters 960]
        [--seed 0]

The lines it printed for seeds 0 and 1 are kept in
`tests/ref_schedule_jax_cpu.log`. It writes JAX's spheres set (48 views
at 200x200) to a temporary directory, removed at the end, trains the hash-grid net in bf16 through the march with
bench.py's settings from PRNGKey(seed), refreshes the occupancy 4x with
PRNGKey(100 + i) as bench.py does, and prints the epochs' mean losses,
the s/step and the PSNRs (pose 0 first, the one bench.py scores).
"""

import argparse
import tempfile
import time
import types

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig  # noqa
from nerfsafetyvalidation_tpu.data import provider as JP  # noqa: E402
from nerfsafetyvalidation_tpu.data.synthetic import generate_dataset  # noqa
from nerfsafetyvalidation_tpu.models import make_network as j_make  # noqa
from nerfsafetyvalidation_tpu.models import renderer as JR  # noqa: E402
from nerfsafetyvalidation_tpu.train.trainer import Trainer as JTrainer  # noqa
from nerfsafetyvalidation_tpu_torch import flagship as F  # noqa: E402
from nerfsafetyvalidation_tpu_torch import train_flagship as TF  # noqa
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax  # noqa
from nerfsafetyvalidation_tpu_torch.models import make_network  # noqa
from nerfsafetyvalidation_tpu_torch.models import renderer as TR  # noqa


def _opt(path, iters, seed):
    """bench.py's `O` of `_train_ref_backbone`."""
    return types.SimpleNamespace(
        path=path, color_space="srgb", scale=1.0, offset=(0.0, 0.0, 0.0),
        bound=1.0, fp16=True, preload=True, rand_pose=-1, downscale=1,
        num_rays=4096, error_map=False, lr=1e-2, iters=iters,
        num_steps=128, upsample_steps=0, max_ray_batch=4096,
        grid_max_samples=48, grid_samples_per_hit=2,
        grid_sample_budget_per_ray=24, grid_warmup_steps=128,
        grid_budget_after_warmup=16, grid_max_samples_after_warmup=32,
        max_steps=1024, dt_gamma=1.0 / 64, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=960)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(8)
    with tempfile.TemporaryDirectory() as path:
        _run(path, args)


def _run(path, args):
    generate_dataset(path, n_train=48, n_val=2, n_test=4, H=200, W=200)
    opt = _opt(path, args.iters, args.seed)
    cfg = JConfig(encoding="hashgrid", bound=1.0, compute_dtype="bfloat16",
                  grid_ray=True, density_thresh=10.0)
    net = j_make(cfg)
    train_loader = JP.NeRFDataset(opt, type="train").dataloader()
    valid_loader = JP.NeRFDataset(opt, type="val").dataloader()
    trainer = JTrainer("refbb", opt, net, workspace=None,
                       use_checkpoint="scratch", fp16=True, mute=True,
                       eval_interval=10 ** 9)
    t0 = time.perf_counter()
    trainer.train(train_loader, valid_loader,
                  int(np.ceil(args.iters / len(train_loader))))
    t_train = time.perf_counter() - t0
    state = trainer.renderer_state
    for i in range(4):
        state = JR.update_extra_state(net, trainer.params, state,
                                      jax.random.PRNGKey(100 + i),
                                      grid_size=cfg.grid_size)
    served = make_network(F.REF_CFG, params_from_jax(
        jax.tree_util.tree_map(np.asarray, trainer.params), "cpu"),
        device="cpu")
    state_t = TR.RendererState(**{
        k: None if v is None else torch.from_numpy(np.array(v))
        for k, v in vars(state).items()})
    poses = F.holdout_poses()
    psnrs, mean = TF._score(served, state_t, poses, TF._truths(poses, F.RES),
                            F.RES, mode="ref_backbone")
    steps = trainer.global_step
    print(f"JAX on the CPU, seed {args.seed}: {steps} steps in "
          f"{t_train:.1f} s ({t_train / steps:.3f} s/step); epoch mean "
          f"losses {[round(v, 6) for v in trainer.stats['loss']]}; "
          f"ref_backbone (the port's frame) on the 4 held-out poses at "
          f"{F.RES}x{F.RES}: {[round(p, 3) for p in psnrs]} (mean "
          f"{mean:.3f}); refbb.ckpt: pose 0 {F.REF_CKPT_DB} dB", flush=True)


if __name__ == "__main__":
    main()
