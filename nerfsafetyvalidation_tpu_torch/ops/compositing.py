"""Volume-rendering transmittance compositing
(nerfsafetyvalidation_tpu/ops/compositing.py):

  alpha_i   = 1 - exp(-delta_i * density_scale * sigma_i)
  T_i       = prod_{j<i} (1 - alpha_j + 1e-15)
  weight_i  = alpha_i * T_i

reduced against rgbs / z / sigma to image / depth / aggregated_density."""

import torch


def composite_weights(sigmas, deltas, density_scale: float = 1.0):
    """sigmas, deltas: [N, T] -> (weights [N, T], alphas [N, T])."""
    alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                         1.0 - alphas + 1e-15], dim=-1)
    trans = torch.cumprod(shifted, dim=-1)[..., :-1]   # exclusive product
    return alphas * trans, alphas


def composite_rays(sigmas, rgbs, deltas, z_vals, nears, fars,
                   density_scale: float = 1.0):
    """The full composite: {'weights', 'weights_sum', 'depth' (normalised
    to [0, 1]), 'image' (before the background), 'aggregated_density' =
    sum_i w_i sigma_i}. sigmas, deltas, z_vals [N, T]; rgbs [N, T, 3];
    nears, fars [N]."""
    weights, _ = composite_weights(sigmas, deltas, density_scale)
    ori_z = torch.clamp((z_vals - nears[..., None])
                        / (fars[..., None] - nears[..., None]), 0.0, 1.0)
    return {
        "weights": weights,
        "weights_sum": weights.sum(dim=-1),
        "depth": (weights * ori_z).sum(dim=-1),
        "image": (weights[..., None] * rgbs).sum(dim=-2),
        "aggregated_density": (weights * sigmas).sum(dim=-1),
    }
