"""Numerical toy check of the Hessian approximations
(nerfsafetyvalidation_tpu/uq/hessian_toy.py; reference uncertainty/
quantification/hessian/HessianToyExample.py): every strategy against the
exact Hessian of a known quadratic, sweeping the finite-difference epsilon,
the regression delta and the ridge alpha, and printing the largest absolute
error of each (for Levenberg-Marquardt, whose g g^T is not the Hessian,
the least eigenvalue of its approximation). Run as a script:

    python -m nerfsafetyvalidation_tpu_torch.uq.hessian_toy
"""

import numpy as np
import torch

from .hessian import HessianApproximator, autodiff_hessian


def quadratic(A):
    A = torch.as_tensor(np.asarray(A), dtype=torch.float32)
    return lambda x: 0.5 * x @ A.to(x.device) @ x


def run_toy_example(verbose: bool = True):
    """{configuration: error} (floats), as the JAX package's."""
    A = np.asarray([[3.0, 1.0, 0.0], [1.0, 2.0, 0.5], [0.0, 0.5, 4.0]])
    f = quadratic(A)
    x0 = torch.tensor([1.0, -1.0, 0.5])
    exact = autodiff_hessian(x0, f).numpy()

    def err(method, **kw):
        H = HessianApproximator(f, method, **kw).compute(x0)
        return np.abs(H.cpu().numpy() - exact).max()

    results = {}
    for eps in (1e-2, 1e-3, 1e-4):
        results[f"finite_difference(eps={eps:g})"] = err(
            "finite_difference", epsilon=eps)
    results["autodiff"] = err("autodiff")
    for delta in (1e-2, 1e-3):
        results[f"regression_gradient(delta={delta:g})"] = err(
            "regression_gradient", delta=delta)
    for alpha in (0.1, 1.0):
        results[f"regression_regularized(alpha={alpha:g})"] = err(
            "regression_gradient_regularized", delta=1e-2, alpha=alpha)
    # LM returns g g^T, not the Hessian: its least eigenvalue instead
    H_lm = HessianApproximator(f, "levenberg_marquardt").compute(x0)
    results["levenberg_marquardt (gg^T, min eig)"] = float(
        np.linalg.eigvalsh(H_lm.cpu().numpy()).min())

    if verbose:
        print(f"exact Hessian:\n{exact}")
        for name, e in results.items():
            print(f"{name:45s} {e:.3e}")
    return results


if __name__ == "__main__":
    run_toy_example()
