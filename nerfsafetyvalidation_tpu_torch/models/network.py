"""The NeRF field of the JAX package's `NeRFNetwork`
(nerfsafetyvalidation_tpu/models/network.py), with a frequency or a
hash-grid position encoding:

  sigma: encode -> bias-free ReLU MLP -> (trunc_exp(sigma), geo_feat)
  color: [SH(d) | geo_feat] -> bias-free ReLU MLP -> sigmoid

Weights are [in, out], so a layer is `x @ W`.

* Frequency encoding (the baked student): `forward` is the JAX `apply`;
  with cfg.fused it runs the whole chain through kernel K1
  (ops/hopper/points_mlp.py). `density` and `color` stay plain matmul
  chains, as they are in the JAX package.
* Hash grid (the reference backbone, corner layout): `forward` is
  `density` then `color`, as the JAX `apply` is for grid nets. With
  cfg.fused each of the two MLPs runs through kernel K4
  (ops/hopper/fused_mlp.py), in bf16 or f32 by cfg.compute_dtype, which
  rounds its last layer to the compute dtype too (a no-op in f32);
  without it they are plain matmul chains whose last layer stays f32
  (the JAX package leaves that route to XLA).
"""

import numpy as np
import torch
from torch import nn

from ..config import NetworkConfig
from ..ops.activation import trunc_exp
from ..ops.freq_encoding import freq_encode, freq_output_dim
from ..ops.hash_encoding import HashGridSpec, hash_grid_encode
from ..ops.hopper.fused_mlp import fused_mlp, fused_mlp_plain
from ..ops.hopper.points_mlp import (_dot, fused_points_sigma_color,
                                     fused_points_sigma_color_plain)
from ..ops.sh_encoding import sh_encode, sh_output_dim


def _linear_init(generator, in_dim: int, out_dim: int):
    """torch nn.Linear's default weight init, [in, out]: uniform in
    +-1/sqrt(in), drawn from `generator` on its device."""
    bound = 1.0 / float(np.sqrt(in_dim))
    u = torch.rand((in_dim, out_dim), generator=generator,
                   device=generator.device)
    return u * (2.0 * bound) - bound


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


def grid_spec_of(cfg: NetworkConfig) -> HashGridSpec:
    """The position encoder's grid, as the JAX `NeRFNetwork` builds it."""
    return HashGridSpec.make(
        input_dim=3, num_levels=cfg.num_levels, level_dim=cfg.level_dim,
        base_resolution=cfg.base_resolution,
        log2_hashmap_size=cfg.log2_hashmap_size,
        desired_resolution=cfg.grid_resolution, gridtype="hash",
        align_corners=cfg.align_corners, aligned=cfg.aligned_levels)


class NeRFNetwork(nn.Module):
    """params: {"sigma_net": [[in, out], ...], "color_net": [...]}, and
    for a hash grid {"encoder": {"embeddings": [rows, level_dim]}}, numpy
    arrays or tensors (see assets.params_from_jax); stored as float32 on
    `device`. Their shapes must be the ones `cfg` describes."""

    def __init__(self, cfg: NetworkConfig, params, device="cuda"):
        super().__init__()
        if cfg.encoding not in ("frequency", "hashgrid"):
            raise NotImplementedError("NeRFNetwork has the frequency and "
                                      "hash-grid encodings only")
        if cfg.bg_radius > 0:
            raise NotImplementedError("the background net is not ported")
        if cfg.encoding_dir != "sphere_harmonics":
            raise NotImplementedError("the port encodes directions with "
                                      "spherical harmonics only")
        self.cfg = cfg
        self.compute_dtype = torch.bfloat16 \
            if cfg.compute_dtype == "bfloat16" else torch.float32
        if cfg.encoding == "hashgrid":
            self.grid_spec = grid_spec_of(cfg)
            self.in_dim = self.grid_spec.output_dim
        else:
            self.grid_spec = None
            self.in_dim = freq_output_dim(3, cfg.multires)
        self.in_dim_dir = sh_output_dim(cfg.sh_degree)

        def t(w):
            return torch.as_tensor(w, dtype=torch.float32, device=device)

        def plist(ws):
            return nn.ParameterList(nn.Parameter(t(w), requires_grad=False)
                                    for w in ws)

        self.sigma_net = plist(params["sigma_net"])
        self.color_net = plist(params["color_net"])
        want = (_widths(self.in_dim, cfg.hidden_dim, cfg.num_layers,
                        1 + cfg.geo_feat_dim)
                + _widths(self.in_dim_dir + cfg.geo_feat_dim,
                          cfg.hidden_dim_color, cfg.num_layers_color, 3))
        got = [tuple(w.shape) for w in [*self.sigma_net, *self.color_net]]
        if self.grid_spec is not None:
            self.embeddings = t(params["encoder"]["embeddings"])
            want.insert(0, (self.grid_spec.offsets[-1], cfg.level_dim))
            got.insert(0, tuple(self.embeddings.shape))
            # the table the encoder gathers from, in the compute dtype (the
            # JAX encode_pos casts it at every call)
            self.table = self.embeddings.to(self.compute_dtype)
        if got != want:
            raise ValueError(f"weights {got} do not match the config {want}")

    def encode_pos(self, x):
        if self.grid_spec is None:
            return freq_encode(x, self.cfg.multires)
        return hash_grid_encode(self.table, x, self.grid_spec,
                                bound=self.cfg.bound,
                                max_level=self.cfg.max_level)

    def encode_dir(self, d):
        return sh_encode(d, self.cfg.sh_degree)

    def _chain(self, weights, h, plain):
        """A grid net's MLP: through K4 with cfg.fused (its plain version
        with `plain`), else the plain matmul chain."""
        if not (self.cfg.fused and self.grid_spec is not None):
            return _mlp(list(weights), h, self.compute_dtype)
        prefix = h.shape[:-1]
        fn = fused_mlp_plain if plain else fused_mlp
        out = fn(h.reshape(-1, h.shape[-1]).contiguous(), list(weights),
                 self.compute_dtype)
        return out.reshape(prefix + (out.shape[-1],))

    def density(self, x, plain: bool = False):
        """x: [..., 3] -> {'sigma': [...], 'geo_feat': [..., 15]}."""
        h = self._chain(self.sigma_net, self.encode_pos(x), plain)
        return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}

    def color(self, d, geo_feat, mask=None, plain: bool = False):
        """d: [..., 3], geo_feat [..., 15] -> rgb [..., 3]; where `mask`
        ([...] bool) is false the rgb is 0, as in the JAX `color`: the
        shapes stay, nothing is compacted."""
        d_enc = self.encode_dir(d)
        if self.cfg.fused and self.grid_spec is not None:
            # K4 reads its input in the compute dtype; geo_feat is exact in
            # it already, so only SH(d) rounds, as JAX's cast of the concat
            # (a no-op in float32)
            d_enc = d_enc.to(self.compute_dtype)
        h = torch.cat([d_enc, geo_feat.to(d_enc.dtype)], dim=-1)
        rgb = torch.sigmoid(self._chain(self.color_net, h, plain))
        if mask is not None:
            rgb = torch.where(mask[..., None], rgb, 0.0)
        return rgb

    def forward(self, x, d, plain: bool = False):
        """(sigma [...], rgb [..., 3]) at positions x and directions d.
        `plain` runs the kernel's plain version (K1 or K4) even on CUDA
        tensors; it exists for comparing the kernel's frame with the plain
        frame."""
        cfg = self.cfg
        if self.grid_spec is not None or not cfg.fused:
            out = self.density(x, plain)
            return out["sigma"], self.color(d, out["geo_feat"], plain=plain)
        prefix = x.shape[:-1]
        xf = x.reshape(-1, 3).contiguous()
        sh = self.encode_dir(d).reshape(xf.shape[0], -1)
        sh = sh.to(self.compute_dtype).contiguous()
        fn = fused_points_sigma_color_plain if plain \
            else fused_points_sigma_color
        sigma, rgb = fn(xf, sh, list(self.sigma_net), list(self.color_net),
                        cfg.multires, self.compute_dtype)
        return sigma.reshape(prefix), rgb.reshape(prefix + (3,))
