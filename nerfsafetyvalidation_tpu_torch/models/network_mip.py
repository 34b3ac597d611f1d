"""The mip-fold teacher field (nerfsafetyvalidation_tpu/models/
network_mip.py, `NeRFNetworkMip`, NetworkConfig(encoding="mipfold")).

  sigma: mip-fold encode (32) -> bias-free ReLU MLP 32 -> 64 -> 16
         -> (trunc_exp(sigma), geo_feat)
  color: [SH(d) | geo_feat] -> bias-free ReLU MLP 31 -> 64 -> 64 -> 3
         -> sigmoid

The encoder reads a fold table built once by `to_folded` (the JAX
package's inference path). `forward` is the JAX `apply` with cfg.fused:
the whole chain after the encoding runs through kernel K3
(ops/hopper/sigma_color.py), which for a CUDA tensor is the only route; on
a CPU tensor K3's plain version runs, with the same rounding points. The
JAX package's unfused chain gives the same values except where sigma's
pre-activation passes +-15 (its trunc_exp does not clip there), so the
port has one route and ignores cfg.fused.
`density` and `color` stay plain matmul chains, as in the JAX package (its
`density` fuses only hash-grid nets).
"""

import torch
from torch import nn

from ..config import NetworkConfig
from ..ops.activation import trunc_exp
from ..ops.hopper.sigma_color import (fused_sigma_color,
                                      fused_sigma_color_plain)
from ..ops.mip_encoding import (MipFoldSpec, build_mip_fold_table,
                                mip_fold_encode)
from ..ops.sh_encoding import sh_encode, sh_output_dim
from .network import _mlp, _widths


def mip_spec_of(cfg: NetworkConfig) -> MipFoldSpec:
    """Scales base * 2^l: dense up to fold_max_scale, hashed above it."""
    scales = tuple(cfg.base_resolution * (2 ** i)
                   for i in range(cfg.num_levels))
    dense = tuple(s for s in scales if s <= cfg.fold_max_scale)
    mip = tuple(s for s in scales if s > cfg.fold_max_scale)
    if not dense or not mip:
        raise ValueError("mipfold needs scales on both sides of "
                         f"fold_max_scale (got {scales})")
    spec = MipFoldSpec(pyramid_scales=dense, pyramid_channels=cfg.level_dim,
                       mip_scales=mip, mip_channels=cfg.level_dim,
                       log2_hashmap_size=cfg.log2_hashmap_size,
                       fold_scale=cfg.fold_scale)
    spec.validate()
    return spec


class NeRFNetworkMip(nn.Module):
    """params: the JAX package's pytree {'encoder': {'pyramid': [...],
    'hash': [...]}, 'sigma_net': [...], 'color_net': [...]} as numpy arrays
    or tensors (see assets.params_from_jax); stored as float32 on
    `device`. Call `to_folded()` before encoding."""

    def __init__(self, cfg: NetworkConfig, params, device="cuda"):
        super().__init__()
        if cfg.encoding != "mipfold":
            raise ValueError("NeRFNetworkMip needs encoding='mipfold'")
        if cfg.encoding_dir != "sphere_harmonics":
            raise NotImplementedError("the port encodes directions with "
                                      "spherical harmonics only")
        self.cfg = cfg
        self.mip_spec = mip_spec_of(cfg)
        self.in_dim = self.mip_spec.output_dim
        self.in_dim_dir = sh_output_dim(cfg.sh_degree)
        self.compute_dtype = torch.bfloat16 \
            if cfg.compute_dtype == "bfloat16" else torch.float32

        def t(w):
            return torch.as_tensor(w, dtype=torch.float32, device=device)

        def plist(ws):
            return nn.ParameterList(nn.Parameter(t(w), requires_grad=False)
                                    for w in ws)

        enc = params["encoder"]
        self.pyramid = [t(g) for g in enc["pyramid"]]
        self.hash = t(enc["hash"])
        self.sigma_net = plist(params["sigma_net"])
        self.color_net = plist(params["color_net"])
        spec = self.mip_spec
        want = ([((s + 1) ** 3, spec.pyramid_channels)
                 for s in spec.pyramid_scales]
                + [(spec.hash_rows, spec.hash_width)]
                + _widths(self.in_dim, cfg.hidden_dim, cfg.num_layers,
                          1 + cfg.geo_feat_dim)
                + _widths(self.in_dim_dir + cfg.geo_feat_dim,
                          cfg.hidden_dim_color, cfg.num_layers_color, 3))
        got = [tuple(w.shape) for w in [*self.pyramid, self.hash,
                                        *self.sigma_net, *self.color_net]]
        if got != want:
            raise ValueError(f"weights {got} do not match the config {want}")
        self.fold_table = None
        self.hash_table = None

    def to_folded(self):
        """Build the fold table [F^3, 8 * Cd] and the hash table in the
        compute dtype (the JAX to_folded, with the hash table's cast done
        once here instead of at every encode). Returns self."""
        self.fold_table = build_mip_fold_table(
            {"pyramid": self.pyramid}, self.mip_spec,
            dtype=self.compute_dtype)
        self.hash_table = self.hash.to(self.compute_dtype)
        return self

    def encode_pos(self, x):
        if self.fold_table is None:
            raise RuntimeError("call to_folded() first: the port encodes "
                               "through the fold table only")
        return mip_fold_encode({"hash": self.hash_table}, x, self.mip_spec,
                               bound=self.cfg.bound,
                               fold_table=self.fold_table,
                               compute_dtype=self.compute_dtype)

    def encode_dir(self, d):
        return sh_encode(d, self.cfg.sh_degree)

    def density(self, x):
        """x: [..., 3] -> {'sigma': [...], 'geo_feat': [..., 15]}."""
        h = _mlp(list(self.sigma_net), self.encode_pos(x),
                 self.compute_dtype)
        return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}

    def color(self, d, geo_feat):
        d_enc = self.encode_dir(d)
        h = torch.cat([d_enc, geo_feat.to(d_enc.dtype)], dim=-1)
        return torch.sigmoid(_mlp(list(self.color_net), h,
                                  self.compute_dtype))

    def forward(self, x, d, plain: bool = False):
        """(sigma [...], rgb [..., 3]) at positions x and directions d,
        through K3. `plain` runs K3's plain version even on CUDA tensors;
        it exists for comparing the kernel's frame with the plain frame."""
        prefix = x.shape[:-1]
        enc = self.encode_pos(x).reshape(-1, self.in_dim).contiguous()
        sh = self.encode_dir(d).reshape(enc.shape[0], -1)
        sh = sh.to(self.compute_dtype).contiguous()
        fn = fused_sigma_color_plain if plain else fused_sigma_color
        sigma, rgb = fn(enc, sh, list(self.sigma_net), list(self.color_net),
                        self.compute_dtype)
        return sigma.reshape(prefix), rgb.reshape(prefix + (3,))
