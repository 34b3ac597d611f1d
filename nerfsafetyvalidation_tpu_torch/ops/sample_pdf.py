"""Hierarchical importance sampling by the inverse CDF
(nerfsafetyvalidation_tpu/ops/sample_pdf.py): a CDF over the bin weights
(+1e-5), deterministic midpoints or uniform draws, inverted by a sorted
search, linear within the bins."""

import numpy as np
import torch


def linspace(start: float, stop: float, num: int, device=None):
    """float32 `num` points from start to stop as the JAX package's
    jnp.linspace gives them on the CPU inside a jit: start * (1 - s) +
    stop * s with s = i * (1 / (num - 1)) (XLA turns the division by the
    constant into a product by its reciprocal), then stop itself.
    torch.linspace differs from it in the last bit of some points."""
    a, b = float(np.float32(start)), float(np.float32(stop))
    if num < 2:
        return torch.full((num,), a, dtype=torch.float32, device=device)
    div = num - 1
    # float32 scalars multiply float32 tensors in float32; nothing is
    # copied from the host, so a caller on the card never waits here
    step = torch.arange(div, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(div))
    return torch.cat([a * (1.0 - step) + b * step,
                      torch.full((1,), b, dtype=torch.float32,
                                 device=device)])


def sample_pdf(bins, weights, n_samples: int, det: bool = False, u=None,
               generator=None):
    """bins: [B, T] z midpoints; weights: [B, T - 1]. Returns [B,
    n_samples]. det=True takes the midpoints linspace(0.5 / n, 1 - 0.5 / n,
    n); det=False takes the uniforms `u` [B, n_samples] handed in (as the
    tests hand in the JAX package's own draws), or draws them from
    `generator`."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, T]
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                     device=cdf.device).expand(shape)
    elif u is None:
        if generator is None:
            raise ValueError("sample_pdf with det=False needs the uniforms "
                             "u or a generator")
        u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.to(cdf.dtype).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
