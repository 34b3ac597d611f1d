"""Gaussian approximation of the volume density's uncertainty
(nerfsafetyvalidation_tpu/uq/gaussian_approximation.py; reference
uncertainty/quantification/gaussian_approximation_density_uncertainty.py):
the maximum-likelihood (mu_d, sigma_d) of

  log(sum(c^2 d^2 sigma^2)) + (mean(r) - sum(c mu d))^2 / sum(c^2 sigma^2 d^2)

over the rendered samples (:24-52). The objective reads five sums of the
render; they are taken in one pass on the render's device and come to the
host in one transfer, where scipy's `minimize` fits the two parameters, as
in the JAX package."""

import numpy as np
import torch
from scipy.optimize import minimize


def sufficient_statistics(c, d, r):
    """c [N, T, 3] colours, d the per-sample densities (any shape that
    reshapes to [N, T, 1]), r the rendered colour -> the tensor [5] of
    sum(c^2 d^2), sum(c d), mean(r), mean(d), std(d) (population std, as
    jnp.std), on their device."""
    d = d.reshape(c.shape[0], c.shape[1], -1)
    return torch.stack([torch.sum(c ** 2 * d ** 2), torch.sum(c * d),
                        torch.mean(r), torch.mean(d),
                        torch.std(d, correction=0)])


class GaussianApproximationDensityUncertainty:
    def __init__(self, c, d, r):
        (self.S_c2d2, self.S_cd, self.r_mean, self.d_mean,
         self.d_std) = sufficient_statistics(c, d, r).tolist()

    def objective(self, params):
        mu_d, sigma_d = params
        s2 = self.S_c2d2 * sigma_d ** 2
        # the log of a positive sum, as the reference's objective takes it
        s2 = max(s2, 1e-30)
        return float(np.log(s2) + (self.r_mean - self.S_cd * mu_d) ** 2 / s2)

    def optimize(self):
        """(mu_d_opt, sigma_d_opt) from the density's mean and std
        (reference :38-52)."""
        result = minimize(self.objective, [self.d_mean, self.d_std])
        mu_d_opt, sigma_d_opt = result.x
        return float(mu_d_opt), float(sigma_d_opt)
