"""NeRF frequency encoding (nerfsafetyvalidation_tpu/ops/freq_encoding.py).

Column order of the reference CUDA kernel: x, then for each frequency k the
block sin(2^k x) (3 columns) followed by cos(2^k x) (3 columns)."""

import torch


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim + input_dim * 2 * degree


def freq_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """x: [..., D] -> [..., D + D*2*degree]."""
    freqs = torch.exp2(torch.arange(degree, dtype=torch.float32,
                                    device=x.device))
    scaled = x[..., None, :] * freqs[:, None]                  # [..., deg, D]
    inter = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    inter = inter.reshape(x.shape[:-1] + (2 * degree * x.shape[-1],))
    return torch.cat([x, inter], dim=-1)
