"""The NeRF field of the JAX package's `NeRFNetwork`
(nerfsafetyvalidation_tpu/models/network.py), with a frequency, a
hash-grid, a tiled-grid or no position encoding (`--encoding
frequency|hashgrid|tiledgrid|None`):

  sigma: encode -> bias-free ReLU MLP -> (trunc_exp(sigma), geo_feat)
  color: [SH(d) | geo_feat] -> bias-free ReLU MLP -> sigmoid
  background (bg_radius > 0): [SH(d) | 2-D hash grid of the sphere
      coordinates] -> bias-free ReLU MLP -> sigmoid (`background`)

Weights are [in, out], so a layer is `x @ W`. A subclass with `mlp_bias`
(NeRFNetworkTCNN) gives each sigma- and color-net layer a bias: the layer
is {"w": [in, out], "b": [out]} in the params pytree, and its weight then
its bias in `param_list` (`mlp_leaves`).

* Frequency encoding (the baked student): `forward` is the JAX `apply`;
  with cfg.fused it runs the whole chain through kernel K1
  (ops/hopper/points_mlp.py). `density` and `color` stay plain matmul
  chains, as they are in the JAX package.
* Without an encoding the sigma net reads the position itself; both MLPs
  are plain matmul chains, as in the JAX package (its `_mlp` is fused
  only for a grid net).
* The background net's grid (4 levels, 2^19 rows, resolution 2048) is
  read in float32 and its MLP is always the plain chain, as the JAX
  `background` does (network.py:292-298).
* Hash or tiled grid (the reference backbone, corner layout): `forward` is
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


def _init_mlp(generator, shapes, bias: bool = False):
    """Fresh layers of the [in, out] `shapes`, drawn as torch nn.Linear
    draws them (the weight, then with `bias` the bias, both uniform in
    +-1/sqrt(in)) from `generator`: [in, out] weights, or {"w", "b"}
    layers with `bias`."""
    layers = []
    for i, o in shapes:
        layer = _linear_init(generator, i, o)
        if bias:
            bound = 1.0 / float(np.sqrt(i))
            u = torch.rand((o,), generator=generator, device=generator.device)
            layer = {"w": layer, "b": u * (2.0 * bound) - bound}
        layers.append(layer)
    return layers


def mlp_leaves(layers):
    """An MLP's tensors in `param_list` order: each layer's weight, then its
    bias where the layer is {"w", "b"}."""
    return [t for ly in layers
            for t in ((ly["w"], ly["b"]) if isinstance(ly, dict) else (ly,))]


def _widths(d_in, hidden, layers, d_out):
    dims = [d_in] + [hidden] * (layers - 1) + [d_out]
    return list(zip(dims[:-1], dims[1:]))


def grid_spec_of(cfg: NetworkConfig) -> HashGridSpec:
    """The position encoder's grid, as the JAX `NeRFNetwork` builds it:
    'tiled' levels for `--encoding tiledgrid` (network.py:81-90)."""
    return HashGridSpec.make(
        input_dim=3, num_levels=cfg.num_levels, level_dim=cfg.level_dim,
        base_resolution=cfg.base_resolution,
        log2_hashmap_size=cfg.log2_hashmap_size,
        desired_resolution=cfg.grid_resolution,
        gridtype="hash" if cfg.encoding == "hashgrid" else "tiled",
        align_corners=cfg.align_corners, aligned=cfg.aligned_levels)


def bg_spec_of(cfg: NetworkConfig) -> HashGridSpec:
    """The background net's grid (network.py:104-110): 2-D, 4 levels,
    2^19 rows, resolution 2048."""
    return HashGridSpec.make(
        input_dim=2, num_levels=4, level_dim=cfg.level_dim,
        base_resolution=cfg.base_resolution, log2_hashmap_size=19,
        desired_resolution=2048, gridtype="hash",
        align_corners=cfg.align_corners)


class NeRFNetwork(nn.Module):
    """params: {"sigma_net": [[in, out], ...], "color_net": [...]}, for a
    grid {"encoder": {"embeddings": [rows, level_dim]}}, and with
    bg_radius > 0 {"encoder_bg": {"embeddings": ...}, "bg_net": [...]}, numpy
    arrays or tensors (see assets.params_from_jax), or None for
    `init(generator)` (a generator on `device` seeded 0 where none is
    given); stored as float32 `nn.Parameter`s on `device`, which take
    gradients when `trainable`. Their shapes must be the ones `cfg`
    describes."""

    def __init__(self, cfg: NetworkConfig, params=None, device="cuda",
                 trainable: bool = False, generator=None):
        super().__init__()
        if cfg.encoding not in ("frequency", "hashgrid", "tiledgrid",
                                "None"):
            raise NotImplementedError(f"encoding {cfg.encoding!r}")
        if cfg.encoding_dir != "sphere_harmonics":
            raise NotImplementedError("the port encodes directions with "
                                      "spherical harmonics only")
        self.cfg = cfg
        self.compute_dtype = torch.bfloat16 \
            if cfg.compute_dtype == "bfloat16" else torch.float32
        self.grid_spec = None
        if cfg.encoding in ("hashgrid", "tiledgrid"):
            self.grid_spec = grid_spec_of(cfg)
            self.in_dim = self.grid_spec.output_dim
        elif cfg.encoding == "frequency":
            self.in_dim = freq_output_dim(3, cfg.multires)
        else:
            self.in_dim = 3
        self.in_dim_dir = sh_output_dim(cfg.sh_degree)
        self.bg_spec = bg_spec_of(cfg) if cfg.bg_radius > 0 else None

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

        if self.grid_spec is not None:
            self.embeddings = p(params["encoder"]["embeddings"])
            self._table = None
        for name in ("sigma_net", "color_net"):
            layers = params[name]
            if self.mlp_bias:
                setattr(self, name + "_b",
                        nn.ParameterList(p(ly["b"]) for ly in layers))
                layers = [ly["w"] for ly in layers]
            setattr(self, name, nn.ParameterList(p(w) for w in layers))
        if self.bg_spec is not None:
            if "encoder_bg" not in params:
                raise ValueError("the config has a background net "
                                 "(bg_radius > 0), the weights none")
            self.embeddings_bg = p(params["encoder_bg"]["embeddings"])
            self.bg_net = nn.ParameterList(p(w) for w in params["bg_net"])
        want = self._param_shapes()
        got = [tuple(w.shape) for w in self.param_list()]
        if got != want:
            raise ValueError(f"weights {got} do not match the config {want}")

    # whether the sigma and color nets' layers have biases, each layer
    # {"w": [in, out], "b": [out]} (NeRFNetworkTCNN)
    mlp_bias = False

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

    def _bg_shapes(self):
        cfg = self.cfg
        return _widths(self.bg_spec.output_dim + self.in_dim_dir,
                       cfg.hidden_dim_bg, cfg.num_layers_bg, 3)

    def _param_shapes(self):
        """The shape of every tensor of `param_list`, in its order."""
        def mlp(shapes):
            return [shape for i, o in shapes for shape in
                    (((i, o), (o,)) if self.mlp_bias else ((i, o),))]
        shapes = mlp(self._sigma_shapes()) + mlp(self._color_shapes())
        if self.grid_spec is not None:
            shapes.insert(0, (self.grid_spec.offsets[-1],
                              self.cfg.level_dim))
        if self.bg_spec is not None:
            shapes += [(self.bg_spec.offsets[-1], self.cfg.level_dim),
                       *self._bg_shapes()]
        return shapes

    def init(self, generator):
        """A fresh params pytree (float32 tensors on the generator's
        device), drawn in the JAX `init`'s order (network.py:125-160): the
        table uniform in +-1e-4 (`hash_grid_init`), each [in, out] weight
        uniform in +-1/sqrt(in) (torch nn.Linear's default), then the
        background's table and weights. The draws come from `generator`,
        so they differ from JAX's."""
        params = {}
        if self.grid_spec is not None:
            params["encoder"] = {"embeddings": hash_grid_init(
                generator, self.grid_spec)}
        params["sigma_net"] = _init_mlp(generator, self._sigma_shapes(),
                                        self.mlp_bias)
        params["color_net"] = _init_mlp(generator, self._color_shapes(),
                                        self.mlp_bias)
        if self.bg_spec is not None:
            params["encoder_bg"] = {"embeddings": hash_grid_init(
                generator, self.bg_spec)}
            params["bg_net"] = _init_mlp(generator, self._bg_shapes())
        return params

    def mlp(self, name):
        """The MLP `name` ('sigma_net' or 'color_net') as the params pytree
        holds it: its [in, out] weights, or {"w", "b"} layers where the
        layers have biases."""
        ws = list(getattr(self, name))
        if not self.mlp_bias:
            return ws
        return [{"w": w, "b": b}
                for w, b in zip(ws, getattr(self, name + "_b"))]

    def param_list(self):
        """Every parameter in the JAX package's init order (table, sigma
        net, color net, background table, background net)."""
        table = [self.embeddings] if self.grid_spec is not None else []
        bg = [self.embeddings_bg, *self.bg_net] \
            if self.bg_spec is not None else []
        return [*table, *mlp_leaves(self.mlp("sigma_net")),
                *mlp_leaves(self.mlp("color_net")), *bg]

    def params_tree(self, ws=None):
        """The parameters, or the tensors `ws` given in `param_list`'s
        order, as the JAX package's pytree of detached tensors (what the
        constructor takes)."""
        ws = [w.detach() for w in (self.param_list() if ws is None else ws)]
        tree = {}
        if self.grid_spec is not None:
            tree["encoder"] = {"embeddings": ws.pop(0)}
        for name in ("sigma_net", "color_net"):
            n = len(getattr(self, name))
            if self.mlp_bias:
                tree[name] = [{"w": w, "b": b} for w, b in
                              zip(ws[:2 * n:2], ws[1:2 * n:2])]
                n *= 2
            else:
                tree[name] = ws[:n]
            ws = ws[n:]
        if self.bg_spec is not None:
            tree["encoder_bg"] = {"embeddings": ws.pop(0)}
            tree["bg_net"] = ws
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
        layout.) A net without a grid has no table: it is returned as it
        is. A tiled grid at the CLI's widths has too many cells for the
        layout: `build_cell_table` refuses it, for JAX's reason."""
        if self.grid_spec is None:
            return self
        view = copy.copy(self)
        with torch.no_grad():
            view.cell_table = build_cell_table(self.table.detach(),
                                               self.grid_spec)
        return view

    def encode_pos(self, x):
        if self.grid_spec is None:
            if self.cfg.encoding == "None":
                return x
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

    @property
    def _sigma_fused(self):
        """Whether the sigma net runs through K4: cfg.fused on a grid net
        (the JAX `density`'s `fused=cfg.fused and grid_spec is not
        None`)."""
        return self.cfg.fused and self.grid_spec is not None

    # the JAX `color`'s flag is the same; NeRFNetworkFF's is cfg.fused
    _color_fused = _sigma_fused

    def _chain(self, weights, h, plain, fused):
        """An MLP: through K4 where `fused` (its plain version with
        `plain`), else the plain matmul chain. Weights [G, in, out] (one
        set per group) take h [G, ..., D]: the grouped K4."""
        if not fused:
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
        h = self._chain(self.sigma_net, self.encode_pos(x), plain,
                        self._sigma_fused)
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
        return trunc_exp(self._chain(sigma_ws, h, False,
                                     self._sigma_fused)[..., 0])

    def color(self, d, geo_feat, mask=None, plain: bool = False):
        """d: [..., 3], geo_feat [..., 15] -> rgb [..., 3]. The color net
        reads [SH(d) | geo_feat | `color_pad` zeros]. Where `mask` ([...]
        bool) is false the rgb is 0, as in the JAX `color`: the shapes
        stay, nothing is compacted."""
        d_enc = self.encode_dir(d)
        if self._color_fused:
            # K4 reads its input in the compute dtype; geo_feat is exact in
            # it already, so only SH(d) rounds, as JAX's cast of the concat
            # (a no-op in float32)
            d_enc = d_enc.to(self.compute_dtype)
        parts = [d_enc, geo_feat.to(d_enc.dtype)]
        if self.color_pad:
            parts.append(d_enc.new_zeros(d_enc.shape[:-1]
                                         + (self.color_pad,)))
        h = torch.cat(parts, dim=-1)
        rgb = torch.sigmoid(self._chain(self.color_net, h, plain,
                                        self._color_fused))
        if mask is not None:
            rgb = torch.where(mask[..., None], rgb, 0.0)
        return rgb

    def background(self, sph, d):
        """The background colour [N, 3] at sphere coordinates sph [N, 2]
        in [-1, 1] (ops.ray_ops.sph_from_ray) and directions d [N, 3]
        (network.py:292-298): the float32 2-D grid, [SH(d) | grid], the
        plain chain, sigmoid."""
        h = hash_grid_encode(self.embeddings_bg, sph, self.bg_spec,
                             bound=1.0)
        d_enc = self.encode_dir(d)
        h = torch.cat([d_enc, h.to(d_enc.dtype)], dim=-1)
        return torch.sigmoid(fused_mlp_reference(h, list(self.bg_net),
                                                 self.compute_dtype))

    def forward(self, x, d, plain: bool = False):
        """(sigma [...], rgb [..., 3]) at positions x and directions d.
        `plain` runs the kernel's plain version (K1 or K4) even on CUDA
        tensors; it exists for comparing the kernel's frame with the plain
        frame."""
        cfg = self.cfg
        if not (cfg.fused and cfg.encoding == "frequency"):
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
