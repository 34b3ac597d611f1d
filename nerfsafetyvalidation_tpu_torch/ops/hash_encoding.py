"""Multiresolution hash-grid encoding, corner layout
(nerfsafetyvalidation_tpu/ops/hash_encoding.py; upstream gridencoder).

The reference semantics, as the JAX package keeps them:

  * per-level scale exp2f(l * S) * H - 1 in float32, resolution
    ceil(scale) + 1 (gridencoder.cu:126-127; S = log2(per_level_scale));
  * per-level table size min(2^log2_hashmap_size, (res [+1])^D), rounded up
    to a multiple of 8;
  * dense strides truncated once they pass the level size; a 'hash' level
    whose dense stride overflows uses the prime-XOR hash;
  * positions outside [0, 1] encode to zero; the output is level-major.

Every sample reads 2^D rows of every level (the corner layout) and blends
them trilinearly. The levels of a chunk of samples are encoded together,
one gather for all of them. Hashes are computed in int64 and masked to 32
bits, so they equal the JAX package's uint32 arithmetic. With a bfloat16
table the blend rounds as JAX does (`_blend`, which the mip-fold encoder
shares).

The encode is differentiable with respect to the table: the corner rows
are one gather, whose backward sums each row's duplicates in a fixed order
(`index_put_` with accumulate), so two runs give the same gradient bit for
bit. `hash_grid_init` draws a fresh table.

The aligned spec (`aligned=True`) and the cell and folded layouts of the
JAX package are not ported.
"""

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

# fast_hash primes (gridencoder.cu:42); index 0 is 1 for memory coherence.
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_MASK32 = 0xFFFFFFFF

# samples encoded at once; bounds the [chunk, L, 2^D, ...] temporaries
ENCODE_CHUNK = 131072


def _corner_bits(input_dim: int) -> np.ndarray:
    """[2^D, D] corner offsets, dimension 0 fastest."""
    idx = np.arange(2 ** input_dim, dtype=np.uint32)
    return (idx[:, None] >> np.arange(input_dim, dtype=np.uint32)[None, :]) & 1


def _prime_hash(grid):
    """fast_hash (gridencoder.cu:36-51) of integer grid coordinates
    [..., D] -> [...] int64 in [0, 2^32): the uint32 products and XORs,
    in int64 masked to 32 bits."""
    h = torch.zeros(grid.shape[:-1], dtype=torch.int64, device=grid.device)
    for d in range(grid.shape[-1]):
        h = h ^ ((grid[..., d].to(torch.int64) * _PRIMES[d]) & _MASK32)
    return h


def _blend_weights(frac):
    """[N, 3] fractions -> [N, 8] trilinear corner weights (x fastest)."""
    bits = torch.as_tensor(_corner_bits(3).astype(bool), device=frac.device)
    f = frac[:, None, :]
    w = torch.where(bits[None], f, 1.0 - f)
    return w[..., 0] * w[..., 1] * w[..., 2]


def _blend(w, feats):
    """sum_c w[:, c] * feats[:, c] over the 8 corners; [N, 8] f32 weights,
    [N, 8, C] features. In bfloat16 each product rounds to bfloat16 and
    the sum runs in float32, rounded once (XLA's bf16 multiply and
    reduce_sum)."""
    if feats.dtype == torch.bfloat16:
        prod = (w.to(torch.bfloat16).float()[..., None]
                * feats.float()).to(torch.bfloat16)
        return prod.float().sum(dim=1).to(torch.bfloat16)
    return (w.to(feats.dtype)[..., None] * feats).sum(dim=1)


@dataclass(frozen=True)
class HashGridSpec:
    """Static description of a multires hash grid; `make` fills the
    derived fields."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    gridtype: str = "hash"  # 'hash' | 'tiled'
    align_corners: bool = False
    aligned: bool = False
    scales: Tuple[float, ...] = field(default=())
    resolutions: Tuple[int, ...] = field(default=())
    offsets: Tuple[int, ...] = field(default=())
    sizes: Tuple[int, ...] = field(default=())
    use_hash: Tuple[bool, ...] = field(default=())
    strides: Tuple[Tuple[int, ...], ...] = field(default=())

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def n_params(self) -> int:
        return self.offsets[-1] * self.level_dim

    @staticmethod
    def make(input_dim=3, num_levels=16, level_dim=2, per_level_scale=2.0,
             base_resolution=16, log2_hashmap_size=19,
             desired_resolution=None, gridtype="hash", align_corners=False,
             aligned=False) -> "HashGridSpec":
        if aligned:
            raise NotImplementedError("the aligned (power-of-two) spec is not "
                                      "ported; the port has the reference "
                                      "spec only")
        if desired_resolution is not None:
            per_level_scale = float(np.exp2(
                np.log2(desired_resolution / base_resolution)
                / (num_levels - 1)))
        S = np.log2(per_level_scale)
        max_params = 2 ** log2_hashmap_size
        scales, resolutions, offsets, sizes, use_hash, strides = \
            [], [], [], [], [], []
        offset = 0
        for lvl in range(num_levels):
            # float32 exp2f(level * S) * H - 1 (gridencoder.cu:126)
            scale = float(np.float32(np.exp2(np.float32(lvl * S)))
                          * np.float32(base_resolution) - np.float32(1.0))
            res = int(np.ceil(scale)) + 1
            side = res if align_corners else res + 1
            params_in_level = min(max_params, side ** input_dim)
            params_in_level = int(np.ceil(params_in_level / 8) * 8)
            # dense strides, truncated like get_grid_index
            # (gridencoder.cu:59-63)
            stride = 1
            lvl_strides = []
            for _ in range(input_dim):
                lvl_strides.append(stride if stride <= params_in_level
                                   else 0)
                stride *= side
            scales.append(scale)
            resolutions.append(res)
            offsets.append(offset)
            sizes.append(params_in_level)
            use_hash.append(gridtype == "hash" and stride > params_in_level)
            strides.append(tuple(lvl_strides))
            offset += params_in_level
        offsets.append(offset)
        return HashGridSpec(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            per_level_scale=per_level_scale, base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size, gridtype=gridtype,
            align_corners=align_corners, scales=tuple(scales),
            resolutions=tuple(resolutions), offsets=tuple(offsets),
            sizes=tuple(sizes), use_hash=tuple(use_hash),
            strides=tuple(strides))


def hash_grid_init(generator, spec: HashGridSpec, std: float = 1e-4):
    """A fresh table [offsets[-1], level_dim] float32, uniform in +-std
    (hash_encoding.py:153; grid.py:133-135), drawn from `generator` on its
    device."""
    u = torch.rand((spec.offsets[-1], spec.level_dim), generator=generator,
                   device=generator.device)
    return u * (2.0 * std) - std


@lru_cache(maxsize=32)
def _level_constants(spec: HashGridSpec, n_active: int, device: str):
    """Per-level constants of the first n_active levels as tensors on
    `device`: scales [La] f32; use_hash, sizes, offsets [La, 1] and
    strides [La, 1, D] int64; corner bits [2^D, D] int64. Made outside
    inference mode, whatever the caller's: a cached inference tensor could
    not be saved for the backward of a later call under autograd."""
    la = slice(0, n_active)

    def t(v, dtype=torch.int64):
        with torch.inference_mode(False):
            return torch.tensor(v, dtype=dtype, device=device)

    return dict(
        scales=t(np.float32(spec.scales[la]), torch.float32),
        use_hash=t(spec.use_hash[la], torch.bool)[:, None],
        sizes=t(spec.sizes[la])[:, None],
        offsets=t(spec.offsets[la])[:, None],
        strides=t(spec.strides[la])[:, None, :],
        bits=t(_corner_bits(spec.input_dim).astype(np.int64)))


def _level_rows(spec: HashGridSpec, corner_grid):
    """Table row (level offset included) of each corner. corner_grid:
    [N, La, 2^D, D] integer grid coordinates of the first La levels ->
    [N, La, 2^D] int64. The uint32 prime-XOR hash on hashed levels, the
    dense index on the others, modulo the level size."""
    c = _level_constants(spec, corner_grid.shape[1], str(corner_grid.device))
    grid = corner_grid.to(torch.int64)
    dense = (grid * c["strides"]).sum(dim=-1) & _MASK32
    index = torch.where(c["use_hash"], _prime_hash(grid), dense)
    return index % c["sizes"] + c["offsets"]


def _n_active(spec: HashGridSpec, max_level):
    if max_level is None:
        return spec.num_levels
    return max(1, min(int(max_level), spec.num_levels))


def _pad_masked_levels(out_lc, n_active: int, spec: HashGridSpec):
    """[N, n_active, C] -> level-major [N, L * C], the levels >= n_active
    zero (they are never gathered)."""
    n = out_lc.shape[0]
    if n_active < spec.num_levels:
        pad = torch.zeros((n, spec.num_levels - n_active, spec.level_dim),
                          dtype=out_lc.dtype, device=out_lc.device)
        out_lc = torch.cat([out_lc, pad], dim=1)
    return out_lc.reshape(n, spec.output_dim)


def _encode_corner_chunk(embeddings, x, spec: HashGridSpec, bound: float,
                         n_active: int):
    if spec.input_dim != 3:
        raise NotImplementedError("the port encodes 3-D positions only")
    c = _level_constants(spec, n_active, str(x.device))
    u = (x.float() + bound) / (2.0 * bound)
    oob = ((u < 0.0) | (u > 1.0)).any(dim=-1)
    pos = u[:, None, :] * c["scales"][None, :, None]        # [N, La, D]
    if not spec.align_corners:
        pos = pos + 0.5
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor
    corner_grid = pos_floor.to(torch.int64)[:, :, None, :] + c["bits"]
    rows = _level_rows(spec, corner_grid)                    # [N, La, 2^D]
    feats = embeddings[rows].reshape(-1, 2 ** spec.input_dim,
                                     spec.level_dim)
    out = _blend(_blend_weights(frac.reshape(-1, spec.input_dim)), feats)
    out = _pad_masked_levels(out.reshape(x.shape[0], n_active,
                                         spec.level_dim), n_active, spec)
    return torch.where(oob[:, None], torch.zeros_like(out), out)


def hash_grid_encode(embeddings, x, spec: HashGridSpec, bound: float = 1.0,
                     max_level=None):
    """Encode positions x [..., D] in [-bound, bound] with the corner-layout
    table embeddings [offsets[-1], C] -> [..., L * C] level-major, in the
    table's dtype, ENCODE_CHUNK samples at a time. Levels >= max_level
    encode to zero and are not gathered. Differentiable with respect to
    `embeddings`."""
    prefix = x.shape[:-1]
    x = x.reshape(-1, spec.input_dim)
    n_active = _n_active(spec, max_level)
    out = torch.empty((x.shape[0], spec.output_dim), dtype=embeddings.dtype,
                      device=embeddings.device)
    for i in range(0, x.shape[0], ENCODE_CHUNK):
        # under autograd the writes record their slices' backward
        out[i:i + ENCODE_CHUNK] = _encode_corner_chunk(
            embeddings, x[i:i + ENCODE_CHUNK], spec, bound, n_active)
    return out.reshape(prefix + (spec.output_dim,))
