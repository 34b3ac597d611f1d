"""The closed-loop engines of both packages over the validate CLI's flight,
on the CPU: the estimate's distance from the true position at each step,
and how far the two packages' states part, step by step.

    PYTHONPATH=. python tests/closed_loop_drift_cpu.py

tests/test_torch_closed_loop.py's net (a 2-level float32 hash grid, 16x16
observations, 24 interest pixels, no UQ engine) on envConfig.json's
flight: 11 steps of dt = T_final / steps = 2/12 s, a 10-knot straight
plan, N_iter = 100 estimator Adam steps and epochs_update = 250 replan
epochs a step, 2 sims, disturbances at envConfig.json's standard
deviations (numpy seed 1). Two runs of each package: at envConfig's
learning rates (lrate and planner_lr, 1e-3), and at 1e-6, where Adam
hardly moves the estimate or the plan, so that the rounding of each step
is not amplified. About seven minutes, most of it the port's Python
loops."""

import time

import jax.numpy as jnp
import numpy as np
import torch

import test_torch_closed_loop as t

STEPS, N_ITER, EPOCHS, DT, PLAN = 11, 100, 250, 2.0 / 12, 12
STD = np.float32([0.02] * 3 + [0.01] * 3 + [0.02] * 3 + [0.01] * 3)
LRS = (1e-3, 1e-6)


def main():
    torch.set_num_threads(4)
    s = t._setup()
    sp, ep = s["start12"][:3], s["end18"][:3]
    slider = np.linspace(0.0, 1.0, PLAN, dtype=np.float32)[1:-1, None]
    s["knots"] = ((1 - slider) * np.append(sp, 0)
                  + slider * np.append(ep, 0)).astype(np.float32)
    noises = (np.random.default_rng(1).normal(0, 1, (2, STEPS, 12))
              .astype(np.float32) * STD)
    net, p = s["net_j"], s["p_j"]
    rot = jnp.asarray(t.ROT)

    def render(ro, rd):
        return t.JR.render(net, p, ro, rd, staged=False, bg_color=1.0,
                           num_steps=8, upsample_steps=0)

    def density(x):
        return 1e-3 * net.density(p, x.reshape((-1, 3)) @ rot)[
            "sigma"].reshape(x.shape[:-1])
    for lr in LRS:
        over = dict(steps=STEPS, dt=DT, n_iter=N_ITER, epochs_update=EPOCHS,
                    est_lr=lr, planner_lr=lr)
        t0 = time.perf_counter()
        eng = t.JCL.ClosedLoopBatchedEngine(
            render_rays_fn=render, density_fn=density,
            **dict(t._common(s), **over))
        out_j = {k: np.asarray(v) for k, v in
                 eng.run(jnp.asarray(noises)).items()}
        t1 = time.perf_counter()
        out_t = {k: v.numpy() for k, v in
                 t._engine_t(s, uq=False, **over).run(noises).items()}
        t2 = time.perf_counter()
        print(f"lr {lr:g} (JAX {t1 - t0:.1f} s with its compile, the port "
              f"{t2 - t1:.1f} s):")
        for name, out in (("jax", out_j), ("torch", out_t)):
            err = np.linalg.norm(out["est_states"][..., :3]
                                 - out["true_states"][..., :3], axis=-1)
            print(f"  {name}: |estimate - truth| (m) by step, mean over "
                  f"sims: {np.round(err.mean(0), 4).tolist()}; mean "
                  f"{err.mean():.4f}")
        for k in ("true_states", "est_states"):
            gap = np.abs(out_j[k] - out_t[k]).max(axis=(0, 2))
            print(f"  max |jax - torch| of {k} by step: "
                  f"{[float(f'{v:.2e}') for v in gap]}")


if __name__ == "__main__":
    main()
