"""optax's adam written out in torch (the JAX package's planner, closed-loop
estimator and in-scan UQ step with `optax.adam`)."""

import numpy as np
import torch


class Adam:
    """optax.adam(lr, b1, b2, eps) over a list of tensors, in optax's order
    of operations: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the
    bias corrections 1 - b^count in float32, p + (-lr) mu_hat /
    (sqrt(nu_hat) + eps). A fresh instance is a fresh optimizer state."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = float(lr), b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        """The updated params (new tensors)."""
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** c)
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * g ** 2 + self.b2 * self.nu[i]
            u = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2)
                                      + self.eps)
            out.append(p + (-self.lr) * u)
        return out
