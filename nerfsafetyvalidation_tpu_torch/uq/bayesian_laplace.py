"""The Bayesian Laplace approximation over the sigma net's weights
(nerfsafetyvalidation_tpu/uq/bayesian_laplace.py; reference uncertainty/
quantification/bayesian_laplace.py).

`fit(X, y)`: the MAP fit of the flat sigma-net vector theta (the nets'
`get_sigma_net_flat` layout) to the densities y at the points X, from a
random normal theta (the reference overwrites the pretrained init, :58),
on `num_perturbations` copies of X each moved by normal noise of scale
0.3: per copy `fit_steps` Adam steps (optax's adam over
exponential_decay(lr, 100, 0.1, staircase), torch's StepLR), keeping the
lowest loss and its theta. As in the JAX package the kept loss is the one
*before* an update and the kept theta the one *after* it (:92-99). Then
the Levenberg-Marquardt Hessian g g^T at the best theta (uq/hessian.py, on
the unmoved X) and the posterior covariance (H + 1e-2 I)^-1, inverted in
float64 and kept in float32 (numpy's inv of the JAX package).

The density runs through the net's `sigma_of_encoding` on the views
`set_sigma_net_flat(theta)`: on a fused hash-grid net (`--ff`) through
kernel K4, forward and backward. The position encoding does not depend on
theta, so it is taken once per copy of X (and once for the LM), not once
per Adam step. The -log posterior and the MAP fit are module functions
over theta [..., n]: one sigma net here, one a sim in the batched
rollouts' in-scan fits (validation/batched.py), which run them over [m,
n] through K4's grouped mode.

Random draws (threefry cannot be reproduced in torch): a torch.Generator
on the net's device seeded `seed` (each JAX fit keys its own from
PRNGKey(seed)), in the JAX package's order: the subsample (with
`max_points`), theta's init [n], the perturbations [P, N, 3]; or `draws`,
a dict of those tensors ("theta_init", "perturbations", "subsample"), as
the tests hand in JAX's.

The net's own weights are never changed: the MAP sigma net is
`self.theta` (the JAX version keeps a params pytree of its own). The JAX
version's `predict` (net.apply without directions) is not ported."""

import numpy as np
import torch

from ..utils.adam import Adam, exponential_decay
from .hessian import HessianApproximator


def negative_log_posterior(net, theta, h, y, prior_mean, prior_std):
    """-log posterior [...] of the sigma nets theta [..., n] (the net's
    flatpack layout), each on its points' position encoding h [..., P, D]
    against their densities y [..., P]: a normal prior N(prior_mean,
    prior_std^2) per weight and a unit-variance Gaussian likelihood."""
    sigma = net.sigma_of_encoding(h, net.set_sigma_net_flat(theta))
    log_prior = -0.5 * torch.sum((theta - prior_mean) ** 2 / prior_std ** 2,
                                 dim=-1)
    log_lik = -0.5 * torch.sum((y - sigma) ** 2, dim=-1)
    return -(log_prior + log_lik)


def nlp_and_grad(net, theta, h, y, prior_mean, prior_std):
    """(`negative_log_posterior` [...], its gradient in theta [..., n])."""
    with torch.enable_grad():
        leaf = theta.detach().requires_grad_(True)
        loss = negative_log_posterior(net, leaf, h, y, prior_mean, prior_std)
        grad, = torch.autograd.grad(loss.sum(), leaf)
    return loss.detach(), grad


@torch.no_grad()
def map_fit(net, theta0, h, y, prior_mean, prior_std, lr, fit_steps):
    """fit_steps Adam steps (optax's adam over exponential_decay(lr, 100,
    0.1, staircase)) of `negative_log_posterior` from theta0 [..., n] ->
    (best loss [...], best theta [..., n]): the lowest loss *before* an
    update, kept with the theta *after* it (bayesian_laplace.py:92-99).
    Every leading index is a fit of its own."""
    adam = Adam([theta0], exponential_decay(lr, 100, 0.1))
    theta, best_theta = theta0, theta0
    best_loss = torch.full(theta0.shape[:-1], float("inf"),
                           device=theta0.device)
    for _ in range(fit_steps):
        loss, grad = nlp_and_grad(net, theta, h, y, prior_mean, prior_std)
        theta, = adam.step([theta], [grad])
        better = loss < best_loss
        best_loss = torch.where(better, loss, best_loss)
        best_theta = torch.where(better[..., None], theta, best_theta)
    return best_loss, best_theta


class BayesianLaplace:
    def __init__(self, net, prior_mean, prior_std, lr,
                 num_perturbations: int = 3, perturbation_scale: float = 0.3,
                 fit_steps: int = 1000, max_points: int = None, seed: int = 0,
                 draws=None):
        self.net = net
        self.prior_mean = prior_mean
        self.prior_std = prior_std
        self.lr = lr
        self.num_perturbations = num_perturbations
        self.perturbation_scale = perturbation_scale
        self.fit_steps = fit_steps
        self.max_points = max_points
        self.device = next(iter(net.sigma_net)).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.draws = draws or {}
        self.theta = net.get_sigma_net_flat()
        self.hessian_approximator = HessianApproximator(
            self.negative_log_posterior_hessian_wrapper,
            method="levenberg_marquardt")
        self.X = self.y = self._h = None

    # ------------------------------------------------------------ posterior
    def log_prior(self, theta):
        return -0.5 * torch.sum((theta - self.prior_mean) ** 2
                                / self.prior_std ** 2)

    def _encode(self, X):
        with torch.no_grad():
            return self.net.encode_pos(X.reshape(-1, 3))

    def log_likelihood(self, theta, X, y):
        sigma = self.net.sigma_of_encoding(
            self._encode(X), self.net.set_sigma_net_flat(theta))
        return -0.5 * torch.sum((y.reshape(-1) - sigma) ** 2)

    def log_posterior(self, theta, X, y):
        return self.log_prior(theta) + self.log_likelihood(theta, X, y)

    def negative_log_posterior(self, theta, X, y):
        return -self.log_posterior(theta, X, y)

    def negative_log_posterior_hessian_wrapper(self, theta):
        """-log posterior at the fitted points (the LM's function)."""
        return negative_log_posterior(self.net, theta, self._h, self.y,
                                      self.prior_mean, self.prior_std)

    # ------------------------------------------------------------------ fit
    def _draw(self, name, shape):
        if name in self.draws:
            d = self.draws[name]
            d = d if torch.is_tensor(d) else torch.from_numpy(np.array(d))
            return d.to(self.device, torch.float32)
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    def map_fit(self, theta0, h, y):
        """fit_steps Adam steps from theta0 on the encoded points h ->
        (best loss, best theta) (`fit`'s per-copy loop)."""
        return map_fit(self.net, theta0, h, y, self.prior_mean,
                       self.prior_std, self.lr, self.fit_steps)

    def fit(self, X, y):
        X = torch.as_tensor(X, dtype=torch.float32,
                            device=self.device).reshape(-1, 3)
        y = torch.as_tensor(y, dtype=torch.float32,
                            device=self.device).reshape(-1)
        if self.max_points is not None and X.shape[0] > self.max_points:
            idx = self.draws.get("subsample")
            if idx is None:
                idx = torch.randperm(X.shape[0], generator=self.generator,
                                     device=self.device)[:self.max_points]
            idx = torch.as_tensor(idx, device=self.device).long()
            X, y = X[idx], y[idx]

        n_theta = self.theta.shape[0]
        theta_init = self._draw("theta_init", (n_theta,))
        perturbations = self._draw(
            "perturbations", (self.num_perturbations,) + tuple(X.shape)) \
            * self.perturbation_scale

        min_loss, min_theta = float("inf"), theta_init
        for p in range(self.num_perturbations):
            loss, theta = self.map_fit(theta_init,
                                       self._encode(X + perturbations[p]), y)
            if float(loss) < min_loss:
                min_loss, min_theta = float(loss), theta

        self.theta = min_theta
        self.posterior_mean = min_theta
        self.X, self.y, self._h = X, y, self._encode(X)
        hessian = self.hessian_approximator.compute(min_theta)
        hessian = hessian + torch.eye(hessian.shape[0], device=self.device) \
            * 1e-2                                       # Tikhonov (:92)
        try:
            cov = torch.linalg.inv(hessian.double())
        except torch.linalg.LinAlgError as e:
            # numpy's inv (the JAX package's) raises its LinAlgError, a
            # ValueError, which validate's restart loop catches
            raise np.linalg.LinAlgError("Singular matrix") from e
        self.posterior_cov = cov.float()
        return self

    def get_posterior_mean(self):
        return self.posterior_mean

    def get_posterior_cov(self):
        return self.posterior_cov

    def set_sigma_net_params(self, updated):
        self.theta = torch.as_tensor(updated, dtype=torch.float32,
                                     device=self.device)
