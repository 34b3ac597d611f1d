"""Seedable per-step multivariate normals (nerfsafetyvalidation_tpu/
validation/distributions.py; reference validation/distributions/
SeedableMultivariateNormal.py): a list of per-step normals with a
per-simulation reseed (:19-22) and `compute_best_solution` (:24-45).

The JAX package folds the simulation number into a threefry key. The port
draws from a torch.Generator on the distributions' device, seeded from
(noise_seed, simulation number) through numpy's SeedSequence, one stream a
simulation, so that a simulation's noise does not depend on the order the
simulations run in. Threefry cannot be drawn in torch, so the two packages'
draws differ; every sampler also takes its standard normals `z`, so that a
test can hand the port the JAX package's draws."""

from typing import List

import numpy as np
import torch

_LOG_2PI = float(np.log(2.0 * np.pi))
# the simulation number compute_best_solution draws its stream with
# (the JAX package folds 2^30 into its key)
BEST_SOLUTION_STREAM = 2 ** 30


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def mvn_log_prob(x, mean, cov):
    """The Gaussian log-density of x [..., k] (torch's
    MultivariateNormal.log_prob), through the Cholesky factor, float32."""
    dev = mean.device if isinstance(mean, torch.Tensor) else None
    x, mean, cov = (_f32(v, dev) for v in (x, mean, cov))
    L = torch.linalg.cholesky(cov)
    diff = (x - mean)[..., None]
    sol = torch.linalg.solve_triangular(L, diff, upper=False)[..., 0]
    k = mean.shape[-1]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                             dim=-1)
    return -0.5 * (k * _LOG_2PI + logdet + torch.sum(sol ** 2, dim=-1))


def mvn_sample(mean, cov, generator=None, z=None):
    """mean + L z, L the Cholesky factor of cov; z standard normals of the
    mean's shape, drawn from `generator` unless given."""
    L = torch.linalg.cholesky(cov)
    if z is None:
        z = torch.randn(mean.shape, generator=generator,
                        device=mean.device)
    return mean + L @ _f32(z, mean.device)


def stream(noise_seed: int, number: int, device) -> torch.Generator:
    """The generator of one simulation number: seeded from (noise_seed,
    number) through numpy's SeedSequence, on `device`."""
    seed = np.random.SeedSequence([int(noise_seed) % 2 ** 32,
                                   int(number)]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


class _Dist:
    """One step's distribution, with torch's log_prob and sample."""

    def __init__(self, mean, cov, device=None):
        self.mean = _f32(mean, device)
        self.cov = _f32(cov, self.mean.device)
        # fail at construction on a covariance that is not positive
        # definite, as torch's constructor does
        chol = np.linalg.cholesky(self.cov.cpu().numpy())
        if not np.isfinite(chol).all():
            raise ValueError("covariance_matrix is not positive definite")

    def log_prob(self, x):
        return mvn_log_prob(x, self.mean, self.cov)

    def sample(self, generator=None, z=None):
        return mvn_sample(self.mean, self.cov, generator, z)


class SeedableMultivariateNormal:
    """means, covs: one [k] mean and [k, k] covariance a step (numpy or
    tensors); noise_seed: an int (None: 0) or a torch.Generator (its
    initial seed); the tensors live on `device` (default: the first
    mean's, else the CPU)."""

    def __init__(self, means: List, covs, noise_seed=None, device=None):
        if device is None:
            device = means[0].device if isinstance(means[0], torch.Tensor) \
                else "cpu"
        self.device = torch.device(device)
        self.means = [_f32(m, self.device) for m in means]
        self.covs = [_f32(c, self.device) for c in covs]
        if noise_seed is None:
            noise_seed = 0
        if hasattr(noise_seed, "initial_seed"):
            noise_seed = noise_seed.initial_seed()
        self.noise_seed = int(noise_seed)
        self.distributions = [_Dist(m, c) for m, c in zip(self.means,
                                                          self.covs)]

    def sample(self, simulationNumber: int, z=None):
        """One noise a step for this simulation (its own stream). z:
        optional [steps, k] standard normals."""
        gen = None if z is not None else stream(
            self.noise_seed, simulationNumber, self.device)
        return [d.sample(gen, None if z is None else z[i])
                for i, d in enumerate(self.distributions)]

    def compute_best_solution(self, simulator, z=None):
        """Run one simulation of the distributions on the simulator; the
        step with the least collision value gives the best mean and
        covariance (:24-45). z: optional [steps, k] standard normals."""
        best_objective_value = 999999999
        best_mean = None
        best_cov = None
        simulator.reset()
        gen = None if z is not None else stream(
            self.noise_seed, BEST_SOLUTION_STREAM, self.device)
        for stepNumber in range(len(self.means)):
            noise = self.distributions[stepNumber].sample(
                gen, None if z is None else z[stepNumber])
            result = simulator.step(noise)
            isCollision, collisionVal, currentPos = result[:3]
            if collisionVal < best_objective_value:
                best_mean = self.means[stepNumber]
                best_cov = self.covs[stepNumber]
                best_objective_value = collisionVal
            if isCollision:
                break
        return best_mean, best_cov, best_objective_value
