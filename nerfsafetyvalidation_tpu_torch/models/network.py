"""The frequency-encoded NeRF field (nerfsafetyvalidation_tpu/models/
network.py, `NeRFNetwork` with encoding="frequency"): the baked student.

  sigma: freq encode -> bias-free ReLU MLP -> (trunc_exp(sigma), geo_feat)
  color: [SH(d) | geo_feat] -> bias-free ReLU MLP -> sigmoid

Weights are [in, out], so a layer is `x @ W`. `forward` is the JAX
`apply`: with cfg.fused it runs the whole chain through kernel K1
(ops/hopper/points_mlp.py). `density` and `color` stay plain matmul chains,
as they are in the JAX package (its `density` fuses only grid nets).
"""

import torch
from torch import nn

from ..config import NetworkConfig
from ..ops.activation import trunc_exp
from ..ops.freq_encoding import freq_encode, freq_output_dim
from ..ops.hopper.points_mlp import (_dot, fused_points_sigma_color,
                                     fused_points_sigma_color_plain)
from ..ops.sh_encoding import sh_encode, sh_output_dim


def _mlp(weights, h, dtype):
    """Bias-free MLP with ReLU between layers; f32 output."""
    for i, w in enumerate(weights):
        h = _dot(h, w, dtype)
        if i != len(weights) - 1:
            h = torch.relu(h)
    return h


def _widths(d_in, hidden, layers, d_out):
    dims = [d_in] + [hidden] * (layers - 1) + [d_out]
    return list(zip(dims[:-1], dims[1:]))


class NeRFNetwork(nn.Module):
    """params: {"sigma_net": [[in, out], ...], "color_net": [...]}, numpy
    arrays or tensors (see assets.params_from_jax); stored as float32 on
    `device`. Their shapes must be the ones `cfg` describes."""

    def __init__(self, cfg: NetworkConfig, params, device="cuda"):
        super().__init__()
        if cfg.encoding != "frequency":
            raise NotImplementedError("the port has the frequency-encoded "
                                      "field only")
        self.cfg = cfg
        self.in_dim = freq_output_dim(3, cfg.multires)
        self.in_dim_dir = sh_output_dim(cfg.sh_degree)
        self.compute_dtype = torch.bfloat16 \
            if cfg.compute_dtype == "bfloat16" else torch.float32

        def plist(ws):
            return nn.ParameterList(
                nn.Parameter(torch.as_tensor(w, dtype=torch.float32,
                                             device=device),
                             requires_grad=False) for w in ws)

        self.sigma_net = plist(params["sigma_net"])
        self.color_net = plist(params["color_net"])
        want = (_widths(self.in_dim, cfg.hidden_dim, cfg.num_layers,
                        1 + cfg.geo_feat_dim)
                + _widths(self.in_dim_dir + cfg.geo_feat_dim,
                          cfg.hidden_dim_color, cfg.num_layers_color, 3))
        got = [tuple(w.shape) for w in [*self.sigma_net, *self.color_net]]
        if got != want:
            raise ValueError(f"weights {got} do not match the config {want}")

    def encode_dir(self, d):
        return sh_encode(d, self.cfg.sh_degree)

    def density(self, x):
        """x: [..., 3] -> {'sigma': [...], 'geo_feat': [..., 15]}."""
        h = _mlp(list(self.sigma_net), freq_encode(x, self.cfg.multires),
                 self.compute_dtype)
        return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}

    def color(self, d, geo_feat):
        h = torch.cat([self.encode_dir(d), geo_feat], dim=-1)
        return torch.sigmoid(_mlp(list(self.color_net), h,
                                  self.compute_dtype))

    def forward(self, x, d, plain: bool = False):
        """(sigma [...], rgb [..., 3]) at positions x and directions d.
        `plain` runs K1's plain version even on CUDA tensors; it exists for
        comparing the kernel's frame with the plain frame."""
        cfg = self.cfg
        if not cfg.fused:
            out = self.density(x)
            return out["sigma"], self.color(d, out["geo_feat"])
        prefix = x.shape[:-1]
        xf = x.reshape(-1, 3).contiguous()
        sh = self.encode_dir(d).reshape(xf.shape[0], -1)
        sh = sh.to(self.compute_dtype).contiguous()
        fn = fused_points_sigma_color_plain if plain \
            else fused_points_sigma_color
        sigma, rgb = fn(xf, sh, list(self.sigma_net), list(self.color_net),
                        cfg.multires, self.compute_dtype)
        return sigma.reshape(prefix), rgb.reshape(prefix + (3,))
