"""optax's adam written out in torch (the JAX package's planner, closed-loop
estimator and in-scan UQ step with `optax.adam`)."""

import numpy as np
import torch


def exponential_decay(init_value, transition_steps, decay_rate):
    """optax.exponential_decay(init_value, transition_steps, decay_rate,
    staircase=True) as a function of the step count: init_value at count
    <= 0, else init_value * decay_rate ** floor(count / transition_steps),
    in float32 (torch's StepLR). The power is exp(p log(rate)) in float64
    rounded to float32, which is what XLA's float32 pow gives on the CPU
    (numpy's powf differs from it by an ulp at some p)."""
    log_rate = np.log(np.float64(np.float32(decay_rate)))

    def schedule(count):
        if count <= 0:
            return float(np.float32(init_value))
        p = np.floor(np.float32(count) / np.float32(transition_steps))
        return float(np.float32(init_value)
                     * np.float32(np.exp(np.float64(p) * log_rate)))
    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """optax.cosine_decay_schedule(init_value, decay_steps, alpha) as a
    function of the step count: init_value * ((1 - alpha) * 0.5 (1 +
    cos(pi * min(count, steps) / steps)) + alpha) in float32, op by op as
    optax computes it outside jit (the cosine rounded from float64; inside
    a jitted update XLA folds the constants and takes its own float32
    cosine, an ulp away at some counts). The distillation passes lr and
    Adam applies the minus sign (optax's scale_by_schedule of -lr)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive "
                         f"decay_steps, got {decay_steps}")
    f32 = np.float32
    steps = f32(decay_steps)

    def schedule(count):
        c = np.minimum(f32(count), steps)
        cos = f32(np.cos(np.float64(f32(np.pi) * c / steps)))
        decayed = f32(1.0 - alpha) * (f32(0.5) * (f32(1.0) + cos)) \
            + f32(alpha)
        return float(f32(init_value) * decayed)
    return schedule


class Adam:
    """optax.adam(lr, b1, b2, eps) over a list of tensors, in optax's order
    of operations: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the
    bias corrections 1 - b^count in float32, p + (-lr) mu_hat /
    (sqrt(nu_hat) + eps). lr is a number or a schedule of the step count
    (0 at the first step, as optax counts; see exponential_decay). A fresh
    instance is a fresh optimizer state."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr = lr if callable(lr) else float(lr)
        self.b1, self.b2, self.eps = b1, b2, eps
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
        lr = self.lr(self.count - 1) if callable(self.lr) else self.lr
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * g ** 2 + self.b2 * self.nu[i]
            u = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2)
                                      + self.eps)
            out.append(p + (-lr) * u)
        return out
