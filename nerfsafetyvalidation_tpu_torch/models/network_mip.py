"""The mip-fold teacher field (nerfsafetyvalidation_tpu/models/
network_mip.py, `NeRFNetworkMip`, NetworkConfig(encoding="mipfold")).

  sigma: mip-fold encode (32) -> bias-free ReLU MLP 32 -> 64 -> 16
         -> (trunc_exp(sigma), geo_feat)
  color: [SH(d) | geo_feat] -> bias-free ReLU MLP 31 -> 64 -> 64 -> 3
         -> sigmoid

The encoder has two routes, as the JAX package's `encode_pos` has:
* training (autograd on, trainable parameters): encode from the pyramid
  and the hash table by `cfg.train_gather` (ops/mip_encoding.py), so the
  gradient reaches them; a fold table is never read here;
* inference: through the fold and hash tables that `to_folded` builds
  once. They are stamped with the parameters' versions, and reading them
  after an optimizer step has changed the parameters raises.
`forward` is the JAX `apply`: with cfg.fused the chain after the encoding
runs through kernel K3 (ops/hopper/sigma_color.py), which for a CUDA tensor
is the only route (on a CPU tensor K3's plain version runs, with the same
rounding points); without it `density` then `color`, plain matmul chains
(under autograd in training, as the JAX trainer runs them). The two differ
only where sigma's pre-activation passes +-15, which K3 clips and
`trunc_exp` does not. Under autograd on the card K3's backward is the
plain chain's VJP (ops/hopper/sigma_color.py), so a fused net trains
through K3, as the JAX net trains through its `custom_vjp`.

The sigma-net flatpack (`get_sigma_net_flat` / `set_sigma_net_flat`, which
the Bayesian-Laplace UQ fits) is the one the JAX net inherits from
`NeRFNetwork` (network.py:304-315): each [in, out] weight as [out, in],
flattened, one after another. `at_fold_scale(w)` is the same net, on the
same parameter tensors, folding its dense levels at scale w: the trainer's
`fold_warmup_scale` (trainer.py `_phase_net`).
"""

import copy
from dataclasses import replace

import torch
from torch import nn

from ..config import NetworkConfig
from ..ops.activation import trunc_exp
from ..ops.hopper.sigma_color import (fused_sigma_color,
                                      fused_sigma_color_plain)
from ..ops.hopper._nvcc import weights_key
from ..ops.mip_encoding import (MipFoldSpec, build_mip_fold_table,
                                mip_fold_encode, mip_fold_init)
from ..ops.sh_encoding import sh_encode, sh_output_dim
from ..ops.hopper.fused_mlp import fused_mlp_reference
from .network import _linear_init, _widths


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
    or tensors (see assets.params_from_jax), or None to draw them with
    `init(generator)` (a generator on `device` seeded 0 where none is
    given); stored as float32 `nn.Parameter`s on `device`, which take
    gradients when `trainable`. Call `to_folded()` before encoding without
    autograd."""

    def __init__(self, cfg: NetworkConfig, params=None, device="cuda",
                 trainable: bool = False, generator=None):
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
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = self.init(generator)

        def p(w):
            w = torch.as_tensor(w, dtype=torch.float32, device=device)
            # a trainable net updates in place: never into the caller's
            # arrays
            return nn.Parameter(w.detach().clone() if trainable else w,
                                requires_grad=trainable)

        enc = params["encoder"]
        self.pyramid = nn.ParameterList(p(g) for g in enc["pyramid"])
        self.hash = p(enc["hash"])
        self.sigma_net = nn.ParameterList(p(w) for w in params["sigma_net"])
        self.color_net = nn.ParameterList(p(w) for w in params["color_net"])
        got = [tuple(w.shape) for w in self.param_list()]
        want = self._shapes()
        if got != want:
            raise ValueError(f"weights {got} do not match the config {want}")
        self.fold_table = None
        self.hash_table = None
        self._folded_from = None

    def _mlp_shapes(self):
        """[in, out] of the sigma net's, then the color net's weights."""
        cfg = self.cfg
        return (_widths(self.in_dim, cfg.hidden_dim, cfg.num_layers,
                        1 + cfg.geo_feat_dim)
                + _widths(self.in_dim_dir + cfg.geo_feat_dim,
                          cfg.hidden_dim_color, cfg.num_layers_color, 3))

    def _shapes(self):
        """Every parameter's shape, in the JAX package's init order:
        pyramid grids, hash table, sigma net, color net."""
        spec = self.mip_spec
        return ([((s + 1) ** 3, spec.pyramid_channels)
                 for s in spec.pyramid_scales]
                + [(spec.hash_rows, spec.hash_width)] + self._mlp_shapes())

    def init(self, generator):
        """A fresh params pytree (float32 tensors on the generator's
        device), drawn as the JAX `init` draws it: the encoder's grids and
        table uniform in +-1e-4, then each [in, out] weight uniform in
        +-1/sqrt(in) (torch nn.Linear's default). The draws come from
        `generator`, so they differ from JAX's."""
        encoder = mip_fold_init(generator, self.mip_spec)
        mlp = [_linear_init(generator, *shape)
               for shape in self._mlp_shapes()]
        n_sigma = self.cfg.num_layers
        return {"encoder": encoder, "sigma_net": mlp[:n_sigma],
                "color_net": mlp[n_sigma:]}

    def param_list(self):
        """Every parameter in the JAX package's init order (pyramid grids,
        hash table, sigma net, color net)."""
        return [*self.pyramid, self.hash, *self.sigma_net, *self.color_net]

    def params_tree(self, ws=None):
        """The parameters, or the tensors `ws` given in `param_list`'s
        order, as the JAX package's pytree of detached tensors (what the
        constructor takes)."""
        ws = [w.detach() for w in (self.param_list() if ws is None else ws)]
        n_pyr, n_sig = len(self.pyramid), len(self.sigma_net)
        return {"encoder": {"pyramid": ws[:n_pyr], "hash": ws[n_pyr]},
                "sigma_net": ws[n_pyr + 1:n_pyr + 1 + n_sig],
                "color_net": ws[n_pyr + 1 + n_sig:]}

    def _encoder_params(self):
        return list(self.pyramid) + [self.hash]

    def to_folded(self):
        """Build the fold table [F^3, 8 * Cd] and the hash table in the
        compute dtype (the JAX to_folded, with the hash table's cast done
        once here instead of at every encode), stamped with the parameters'
        versions. Returns self."""
        with torch.no_grad():
            self.fold_table = build_mip_fold_table(
                {"pyramid": list(self.pyramid)}, self.mip_spec,
                dtype=self.compute_dtype)
            self.hash_table = self.hash.to(self.compute_dtype)
        self._folded_from = weights_key(self._encoder_params())
        return self

    def encode_pos(self, x):
        kw = dict(bound=self.cfg.bound, compute_dtype=self.compute_dtype)
        if torch.is_grad_enabled() and self.hash.requires_grad:
            return mip_fold_encode(
                {"pyramid": list(self.pyramid), "hash": self.hash}, x,
                self.mip_spec, train_gather=self.cfg.train_gather, **kw)
        if self.fold_table is None:
            raise RuntimeError("call to_folded() first: without autograd "
                               "the encoder reads the fold table")
        if self._folded_from != weights_key(self._encoder_params()):
            raise RuntimeError("the fold table was built from older "
                               "parameters; call to_folded() again")
        return mip_fold_encode({"hash": self.hash_table}, x, self.mip_spec,
                               fold_table=self.fold_table, **kw)

    def encode_dir(self, d):
        return sh_encode(d, self.cfg.sh_degree)

    def density(self, x):
        """x: [..., 3] -> {'sigma': [...], 'geo_feat': [..., 15]}."""
        h = fused_mlp_reference(self.encode_pos(x), list(self.sigma_net),
                                self.compute_dtype)
        return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}

    def get_sigma_net_flat(self):
        """The sigma net's weights as one flat float32 vector (detached) in
        the JAX layout: each [in, out] weight as [out, in], flattened, one
        after another (network.py:304-307, which the JAX mip-fold net
        inherits)."""
        return torch.cat([w.detach().t().reshape(-1) for w in self.sigma_net])

    def set_sigma_net_flat(self, theta):
        """The sigma net's weights made of theta [..., n] (the JAX layout):
        [..., in, out] views of it, differentiable in theta; the net's own
        weights stay as they are (network.py:309-315 returns a new
        pytree)."""
        ws, start = [], 0
        lead = theta.shape[:-1]
        for w in self.sigma_net:
            i, o = w.shape
            ws.append(theta[..., start:start + i * o].reshape(
                lead + (o, i)).transpose(-1, -2))
            start += i * o
        if start != theta.shape[-1]:
            raise ValueError(f"theta has {theta.shape[-1]} entries, the "
                             f"sigma net {start}")
        return ws

    def sigma_of_encoding(self, h, sigma_ws):
        """`density`'s sigma [...] of the position encoding h [..., D]
        through the sigma net `sigma_ws` (`set_sigma_net_flat`'s; with a
        leading group axis, h is [G, ..., D]): the plain matmul chain, as
        `density` runs it."""
        return trunc_exp(fused_mlp_reference(h, list(sigma_ws),
                                             self.compute_dtype)[..., 0])

    def at_fold_scale(self, scale: int):
        """This net, on the same parameter tensors (a step through it
        trains them), with its dense levels materialised, folded and
        encoded at `scale` (MipFoldSpec.fold_scale; 0 is the native scale):
        the JAX trainer's warm-up net, `make_network(replace(cfg,
        fold_scale=scale))` on the same params. It has no fold table of
        its own until `to_folded`."""
        net = copy.copy(self)       # shares the parameter lists
        net.cfg = replace(self.cfg, fold_scale=scale)
        net.mip_spec = mip_spec_of(net.cfg)
        net.fold_table = net.hash_table = net._folded_from = None
        return net

    def color(self, d, geo_feat, mask=None):
        """rgb [..., 3], 0 where `mask` ([...] bool) is false."""
        d_enc = self.encode_dir(d)
        h = torch.cat([d_enc, geo_feat.to(d_enc.dtype)], dim=-1)
        rgb = torch.sigmoid(fused_mlp_reference(h, list(self.color_net),
                                                self.compute_dtype))
        if mask is not None:
            rgb = torch.where(mask[..., None], rgb, 0.0)
        return rgb

    def forward(self, x, d, plain: bool = False):
        """(sigma [...], rgb [..., 3]) at positions x and directions d:
        through K3 with cfg.fused (`plain` runs K3's plain version even on
        CUDA tensors, for comparing the kernel's frame with the plain
        frame), else `density` then `color`."""
        if not self.cfg.fused:
            out = self.density(x)
            return out["sigma"], self.color(d, out["geo_feat"])
        prefix = x.shape[:-1]
        enc = self.encode_pos(x).reshape(-1, self.in_dim).contiguous()
        sh = self.encode_dir(d).reshape(enc.shape[0], -1)
        sh = sh.to(self.compute_dtype).contiguous()
        fn = fused_sigma_color_plain if plain else fused_sigma_color
        sigma, rgb = fn(enc, sh, list(self.sigma_net), list(self.color_net),
                        self.compute_dtype)
        return sigma.reshape(prefix), rgb.reshape(prefix + (3,))
