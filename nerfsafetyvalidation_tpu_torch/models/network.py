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

The sigma-net flatpack (the JAX package's `get_sigma_net_flat` /
`set_sigma_net_flat`, which the Bayesian-Laplace UQ fits): the sigma net's
weights as one flat vector theta in the JAX layout (each [in, out] weight
transposed to [out, in], flattened, one after another), so a vector
carries across the packages bit for bit. `set_sigma_net_flat(theta)`
returns the weights as views of theta (theta [..., n] gives [..., in, out]
each, a leading axis one sigma net per group) and leaves the net's own
unchanged, as the JAX version returns a new pytree; `sigma_of_encoding`
runs the density's sigma through them, so autograd reaches theta (through
K4's Function on a fused grid net, the grouped kernel for a leading
axis).

Training: `init(generator)` draws fresh weights as the JAX `init` does
(the table uniform in +-1e-4, each [in, out] weight uniform in
+-1/sqrt(in)), from a torch.Generator, so the draws differ from JAX's.
With `trainable` every parameter takes gradients: the table is cast to the
compute dtype at every call while autograd records (the JAX `encode_pos`
casts it at every call), so the gradient reaches the float32 table; a cast
copy is kept for calls without autograd, made again after the table
changes.
"""

import copy

import numpy as np
import torch
from torch import nn

from ..config import NetworkConfig
from ..ops.activation import trunc_exp
from ..ops.freq_encoding import freq_encode, freq_output_dim
from ..ops.hash_encoding import (HashGridSpec, build_cell_table,
                                 hash_grid_encode, hash_grid_encode_cell,
                                 hash_grid_init)
from ..ops.hopper._nvcc import weights_key
from ..ops.hopper.fused_mlp import (fused_mlp, fused_mlp_grouped,
                                    fused_mlp_grouped_plain, fused_mlp_plain,
                                    fused_mlp_reference)
from ..ops.hopper.points_mlp import (fused_points_sigma_color,
                                     fused_points_sigma_color_plain)
from ..ops.sh_encoding import sh_encode, sh_output_dim


def _linear_init(generator, in_dim: int, out_dim: int):
    """torch nn.Linear's default weight init, [in, out]: uniform in
    +-1/sqrt(in), drawn from `generator` on its device."""
    bound = 1.0 / float(np.sqrt(in_dim))
    u = torch.rand((in_dim, out_dim), generator=generator,
                   device=generator.device)
    return u * (2.0 * bound) - bound


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
    arrays or tensors (see assets.params_from_jax), or None for
    `init(generator)` (a generator on `device` seeded 0 where none is
    given); stored as float32 `nn.Parameter`s on `device`, which take
    gradients when `trainable`. Their shapes must be the ones `cfg`
    describes."""

    def __init__(self, cfg: NetworkConfig, params=None, device="cuda",
                 trainable: bool = False, generator=None):
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

        def plist(ws):
            return nn.ParameterList(p(w) for w in ws)

        self.sigma_net = plist(params["sigma_net"])
        self.color_net = plist(params["color_net"])
        want = self._shapes()
        got = [tuple(w.shape) for w in [*self.sigma_net, *self.color_net]]
        if self.grid_spec is not None:
            self.embeddings = p(params["encoder"]["embeddings"])
            want.insert(0, (self.grid_spec.offsets[-1], cfg.level_dim))
            got.insert(0, tuple(self.embeddings.shape))
            self._table = None
        if got != want:
            raise ValueError(f"weights {got} do not match the config {want}")

    # zero columns appended to the color net's input [SH | geo_feat]
    color_pad = 0

    def _sigma_shapes(self):
        cfg = self.cfg
        return _widths(self.in_dim, cfg.hidden_dim, cfg.num_layers,
                       1 + cfg.geo_feat_dim)

    def _color_shapes(self):
        cfg = self.cfg
        return _widths(self.in_dim_dir + cfg.geo_feat_dim + self.color_pad,
                       cfg.hidden_dim_color, cfg.num_layers_color, 3)

    def _shapes(self):
        """[in, out] of every layer, the sigma net's then the color net's."""
        return self._sigma_shapes() + self._color_shapes()

    def init(self, generator):
        """A fresh params pytree (float32 tensors on the generator's
        device), drawn in the JAX `init`'s order (network.py:125-160): the
        table uniform in +-1e-4 (`hash_grid_init`), then each [in, out]
        weight uniform in +-1/sqrt(in) (torch nn.Linear's default). The
        draws come from `generator`, so they differ from JAX's."""
        params = {}
        if self.grid_spec is not None:
            params["encoder"] = {"embeddings": hash_grid_init(
                generator, self.grid_spec)}
        mlp = [_linear_init(generator, *shape) for shape in self._shapes()]
        n_sigma = len(self._sigma_shapes())
        params["sigma_net"] = mlp[:n_sigma]
        params["color_net"] = mlp[n_sigma:]
        return params

    def param_list(self):
        """Every parameter in the JAX package's init order (table, sigma
        net, color net)."""
        table = [self.embeddings] if self.grid_spec is not None else []
        return [*table, *self.sigma_net, *self.color_net]

    def params_tree(self, ws=None):
        """The parameters, or the tensors `ws` given in `param_list`'s
        order, as the JAX package's pytree of detached tensors (what the
        constructor takes)."""
        ws = [w.detach() for w in (self.param_list() if ws is None else ws)]
        tree = {}
        if self.grid_spec is not None:
            tree["encoder"] = {"embeddings": ws.pop(0)}
        n_sigma = len(self.sigma_net)
        tree["sigma_net"], tree["color_net"] = ws[:n_sigma], ws[n_sigma:]
        return tree

    @property
    def table(self):
        """The table the encoder gathers from, in the compute dtype. While
        autograd records for a trainable table it is cast at this call;
        otherwise a cast copy is kept until the table changes (its version
        or storage)."""
        emb = self.embeddings
        if torch.is_grad_enabled() and emb.requires_grad:
            return emb.to(self.compute_dtype)
        key = weights_key([emb])
        if self._table is None or self._table[0] != key:
            with torch.no_grad():
                self._table = (key, emb.to(self.compute_dtype))
        return self._table[1]

    # the cell-layout table of a `to_cell` view; None on the net itself
    cell_table = None

    def to_cell(self):
        """A render-only view of the net whose position encoder reads the
        cell layout (ops/hash_encoding.build_cell_table, one row a sample
        and level), built from the table cast to the compute dtype (the
        JAX `to_cell`, network.py:166-178). The view shares this net's MLP
        weights; the net itself keeps the corner layout. The JAX `to_cell`
        returns new params that only the observation render reads, while
        the planner's density, the estimator's render and the engines keep
        the corner params; the two layouts differ on hashed levels, so the
        cell table must not reach those, and the port returns a view
        rather than changing the net. (The mip-fold net's `to_folded`
        changes the net instead: every caller of that net reads the folded
        layout.) A frequency-encoded net has no table: it is returned as
        it is."""
        if self.grid_spec is None:
            return self
        view = copy.copy(self)
        with torch.no_grad():
            view.cell_table = build_cell_table(self.table.detach(),
                                               self.grid_spec)
        return view

    def encode_pos(self, x):
        if self.grid_spec is None:
            return freq_encode(x, self.cfg.multires)
        if self.cell_table is not None:
            return hash_grid_encode_cell(self.cell_table, x, self.grid_spec,
                                         bound=self.cfg.bound,
                                         max_level=self.cfg.max_level)
        return hash_grid_encode(self.table, x, self.grid_spec,
                                bound=self.cfg.bound,
                                max_level=self.cfg.max_level)

    def encode_dir(self, d):
        return sh_encode(d, self.cfg.sh_degree)

    def _chain(self, weights, h, plain):
        """A grid net's MLP: through K4 with cfg.fused (its plain version
        with `plain`), else the plain matmul chain. Weights [G, in, out]
        (one set per group) take h [G, ..., D]: the grouped K4."""
        if not (self.cfg.fused and self.grid_spec is not None):
            return fused_mlp_reference(h, list(weights), self.compute_dtype)
        if weights[0].ndim == 3:
            G = h.shape[0]
            fn = fused_mlp_grouped_plain if plain else fused_mlp_grouped
            out = fn(h.reshape(G, -1, h.shape[-1]), list(weights),
                     self.compute_dtype)
            return out.reshape(h.shape[:-1] + (out.shape[-1],))
        prefix = h.shape[:-1]
        fn = fused_mlp_plain if plain else fused_mlp
        out = fn(h.reshape(-1, h.shape[-1]).contiguous(), list(weights),
                 self.compute_dtype)
        return out.reshape(prefix + (out.shape[-1],))

    def density(self, x, plain: bool = False):
        """x: [..., 3] -> {'sigma': [...], 'geo_feat': [..., 15]}."""
        h = self._chain(self.sigma_net, self.encode_pos(x), plain)
        return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}

    # ------------------------------------------------ the sigma-net flatpack
    def get_sigma_net_flat(self):
        """The sigma net's weights as one flat float32 vector (detached) in
        the JAX layout: each [in, out] weight as [out, in], flattened, one
        after another (models/network.py:308-311)."""
        return torch.cat([w.detach().t().reshape(-1) for w in self.sigma_net])

    def set_sigma_net_flat(self, theta):
        """The sigma net's weights made of theta [..., n] (the JAX layout):
        [..., in, out] views of it, differentiable in theta; the net's own
        weights stay as they are (network.py:313-317 returns a new
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
        leading group axis, h is [G, ..., D]). The Laplace fits encode
        their points once and call this at every step."""
        return trunc_exp(self._chain(sigma_ws, h, False)[..., 0])

    def color(self, d, geo_feat, mask=None, plain: bool = False):
        """d: [..., 3], geo_feat [..., 15] -> rgb [..., 3]. The color net
        reads [SH(d) | geo_feat | `color_pad` zeros]. Where `mask` ([...]
        bool) is false the rgb is 0, as in the JAX `color`: the shapes
        stay, nothing is compacted."""
        d_enc = self.encode_dir(d)
        if self.cfg.fused and self.grid_spec is not None:
            # K4 reads its input in the compute dtype; geo_feat is exact in
            # it already, so only SH(d) rounds, as JAX's cast of the concat
            # (a no-op in float32)
            d_enc = d_enc.to(self.compute_dtype)
        parts = [d_enc, geo_feat.to(d_enc.dtype)]
        if self.color_pad:
            parts.append(d_enc.new_zeros(d_enc.shape[:-1]
                                         + (self.color_pad,)))
        h = torch.cat(parts, dim=-1)
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
