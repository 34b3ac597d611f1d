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
them multilinearly: D = 3 for positions, D = 2 for the background net's
sphere coordinates. A 'tiled' grid (`--encoding tiledgrid`) never hashes:
each level wraps its dense index modulo its size. The levels of a chunk of
samples are encoded together, one gather for all of them. Hashes are
computed in int64 and masked to 32 bits, so they equal the JAX package's
uint32 arithmetic. With a bfloat16 table the blend rounds as JAX does
(`_blend`, which the mip-fold encoder shares).

The encode is differentiable with respect to the table: the corner rows
are one gather, whose backward sums each row's duplicates in a fixed order
(`index_put_` with accumulate), so two runs give the same gradient bit for
bit. `hash_grid_init` draws a fresh table.

The cell layout (`build_cell_table`, `hash_grid_encode_cell`): a table of
one row a grid cell holding its 2^D corner features side by side, so that
a sample reads one row a level. Dense levels convert exactly; hashed levels
hash the cell's coordinate into 2^log2_hashmap_size rows, each filled from
one of its cells (the last of the cells sampled into it), so they alias
whole corner tuples where the corner layout aliases single corners. The
validate CLI's `--fast_render` observations read it
(`NeRFNetwork.to_cell`).

The aligned spec (`aligned=True`) and the folded layout of the JAX package
are not ported.
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
    """[N, D] fractions -> [N, 2^D] multilinear corner weights (x
    fastest), the product over the dimensions taken in order."""
    D = frac.shape[-1]
    bits = torch.as_tensor(_corner_bits(D).astype(bool), device=frac.device)
    f = frac[:, None, :]
    w = torch.where(bits[None], f, 1.0 - f)
    out = w[..., 0]
    for d in range(1, D):
        out = out * w[..., d]
    return out


def _blend(w, feats):
    """sum_c w[:, c] * feats[:, c] over the 2^D corners; [N, 2^D] f32
    weights, [N, 2^D, C] features. In bfloat16 each product rounds to
    bfloat16 and the sum runs in float32, rounded once (XLA's bf16 multiply
    and reduce_sum)."""
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


def _rows(grid, use_hash, strides, sizes, offsets):
    """Table rows of integer grid coordinates [..., D]: the uint32 prime-XOR
    hash where `use_hash`, else the uint32 dense index sum(grid * strides),
    modulo the level size, plus the level offset (the level constants
    broadcast against grid's leading axes)."""
    grid = grid.to(torch.int64)
    dense = (grid * strides).sum(dim=-1) & _MASK32
    index = torch.where(use_hash, _prime_hash(grid), dense)
    return index % sizes + offsets


def _level_rows(spec: HashGridSpec, corner_grid):
    """Table row (level offset included) of each corner. corner_grid:
    [N, La, 2^D, D] integer grid coordinates of the first La levels ->
    [N, La, 2^D] int64."""
    c = _level_constants(spec, corner_grid.shape[1], str(corner_grid.device))
    return _rows(corner_grid, c["use_hash"], c["strides"], c["sizes"],
                 c["offsets"])


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


# --------------------------------------------------------- the cell layout
def cell_sizes(spec: HashGridSpec):
    """Per-level cell-table (sizes, offsets, strides): dense levels hold
    res^D cells (strides 1, res, res^2, ...), hashed levels the same
    2^log2_hashmap_size rows as the corner layout's budget."""
    sizes, offsets, strides = [], [], []
    off = 0
    for lvl in range(spec.num_levels):
        res = spec.resolutions[lvl]
        if spec.use_hash[lvl]:
            size = 2 ** spec.log2_hashmap_size
            lvl_strides = (0,) * spec.input_dim
        else:
            size = res ** spec.input_dim
            lvl_strides = tuple(res ** d for d in range(spec.input_dim))
        sizes.append(size)
        offsets.append(off)
        strides.append(lvl_strides)
        off += size
    offsets.append(off)
    return sizes, offsets, strides


@lru_cache(maxsize=32)
def _cell_constants(spec: HashGridSpec, n_active: int, device: str):
    """`_level_constants` of the cell layout: use_hash, sizes, offsets
    [La] and strides [La, D] int64 of the first n_active levels."""
    sizes, offsets, strides = cell_sizes(spec)
    la = slice(0, n_active)

    def t(v, dtype=torch.int64):
        with torch.inference_mode(False):
            return torch.tensor(v, dtype=dtype, device=device)

    return dict(use_hash=t(spec.use_hash[la], torch.bool),
                sizes=t(sizes[la]), offsets=t(offsets[la]),
                strides=t(strides[la]))


def _cell_rows(spec: HashGridSpec, cell_grid, lvl=None):
    """Cell-table row (level offset included) of each cell. cell_grid:
    [N, La, D] integer cell coordinates of the first La levels -> [N, La]
    int64; with `lvl`, [..., D] of that level alone -> [...]."""
    if lvl is None:
        c = _cell_constants(spec, cell_grid.shape[-2], str(cell_grid.device))
        return _rows(cell_grid, c["use_hash"], c["strides"], c["sizes"],
                     c["offsets"])
    c = _cell_constants(spec, lvl + 1, str(cell_grid.device))
    return _rows(cell_grid, c["use_hash"][lvl], c["strides"][lvl],
                 c["sizes"][lvl], c["offsets"][lvl])


def _level_cells(spec: HashGridSpec, lvl: int, size: int) -> np.ndarray:
    """The cells [M, D] uint32 whose corners fill level lvl's rows, in the
    JAX package's order: every cell (x slowest), or on a hashed level with
    more than 4 * size cells, 4 * size cells drawn by numpy from
    default_rng(lvl) (they fill ~98% of the rows)."""
    res, D = spec.resolutions[lvl], spec.input_dim
    if spec.use_hash[lvl] and res ** D > size * 4:
        return np.random.default_rng(lvl).integers(0, res, (size * 4, D),
                                                   dtype=np.uint32)
    g = np.arange(res, dtype=np.uint32)
    grids = np.meshgrid(*([g] * D), indexing="ij")
    return np.stack([c.ravel() for c in grids], -1)


# rows a cell table may hold: the JAX package indexes it with int32
# (`_cell_rows` casts its rows to int32)
MAX_CELL_ROWS = 2 ** 31 - 1


def build_cell_table(embeddings, spec: HashGridSpec):
    """The cell-layout table [total cells, 2^D * C] of a corner-layout table
    embeddings [offsets[-1], C], in its dtype and on its device (the JAX
    package's build_cell_table). A row holds its cell's 2^D corner
    features (corner-major, x fastest), read from the corner layout. Where
    several cells land in one row, the last of them in the order of
    `_level_cells` fills it, as the JAX scatter keeps the last of
    duplicate indices on the CPU: the winner is each row's largest sample
    position (a scatter-max), so that every build on every device gives
    the same bits. A row no cell lands in stays zero.

    A tiled level never hashes, so its cell table holds all res^D cells:
    a table past MAX_CELL_ROWS (a tiled grid at the CLI's widths, up to
    2049^3 cells a level) is refused, for the reason the JAX build fails
    there."""
    sizes, offsets, _ = cell_sizes(spec)
    if offsets[-1] > MAX_CELL_ROWS:
        raise ValueError(
            f"the cell layout of this grid has {offsets[-1]} rows (a "
            f"{spec.gridtype} level holds all res^{spec.input_dim} cells, up "
            f"to {max(spec.resolutions)}^{spec.input_dim}): past the int32 "
            "rows of the JAX package's build_cell_table, which also "
            "enumerates every cell of such a level with numpy and cannot "
            "hold them in memory")
    D = spec.input_dim
    dev = embeddings.device
    bits = torch.as_tensor(_corner_bits(D).astype(np.int64), device=dev)
    C = embeddings.shape[1]
    table = torch.zeros((offsets[-1], 2 ** D * C), dtype=embeddings.dtype,
                        device=dev)
    for lvl in range(spec.num_levels):
        cells = torch.as_tensor(
            _level_cells(spec, lvl, sizes[lvl]).astype(np.int64), device=dev)
        rows = _cell_rows(spec, cells, lvl) - offsets[lvl]
        order = torch.arange(cells.shape[0], dtype=torch.int64, device=dev)
        last = torch.full((sizes[lvl],), -1, dtype=torch.int64, device=dev)
        last.scatter_reduce_(0, rows, order, reduce="amax")
        filled = torch.nonzero(last >= 0)[:, 0]
        corners = cells[last[filled]][:, None, :] + bits  # [R, 2^D, D]
        c = _level_constants(spec, lvl + 1, str(dev))
        corner_rows = _rows(corners, c["use_hash"][lvl], c["strides"][lvl],
                            c["sizes"][lvl], c["offsets"][lvl])
        table[offsets[lvl] + filled] = embeddings[corner_rows].reshape(
            -1, 2 ** D * C)
    return table


def _encode_cell_chunk(cell_table, x, spec: HashGridSpec, bound: float,
                       n_active: int):
    c = _level_constants(spec, n_active, str(x.device))
    u = (x.float() + bound) / (2.0 * bound)
    oob = ((u < 0.0) | (u > 1.0)).any(dim=-1)
    pos = u[:, None, :] * c["scales"][None, :, None]        # [N, La, D]
    if not spec.align_corners:
        pos = pos + 0.5
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor
    rows = _cell_rows(spec, pos_floor.to(torch.int64))       # [N, La]
    feats = cell_table[rows].reshape(-1, 2 ** spec.input_dim,
                                     spec.level_dim)
    out = _blend(_blend_weights(frac.reshape(-1, spec.input_dim)), feats)
    out = _pad_masked_levels(out.reshape(x.shape[0], n_active,
                                         spec.level_dim), n_active, spec)
    return torch.where(oob[:, None], torch.zeros_like(out), out)


def hash_grid_encode_cell(cell_table, x, spec: HashGridSpec,
                          bound: float = 1.0, max_level=None):
    """`hash_grid_encode` through the cell layout (`build_cell_table`): one
    row a sample and level, blended as the corner encode blends. Equal to
    the corner encode on dense levels; on hashed levels it differs only in
    what collides. Levels >= max_level encode to zero and are not
    gathered. x [..., D] -> [..., L * C] in the table's dtype."""
    prefix = x.shape[:-1]
    x = x.reshape(-1, spec.input_dim)
    n_active = _n_active(spec, max_level)
    out = torch.empty((x.shape[0], spec.output_dim), dtype=cell_table.dtype,
                      device=cell_table.device)
    for i in range(0, x.shape[0], ENCODE_CHUNK):
        out[i:i + ENCODE_CHUNK] = _encode_cell_chunk(
            cell_table, x[i:i + ENCODE_CHUNK], spec, bound, n_active)
    return out.reshape(prefix + (spec.output_dim,))
