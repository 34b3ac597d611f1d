"""Mip-fold position encoding of the teacher field
(nerfsafetyvalidation_tpu/ops/mip_encoding.py), inference and training.

The dense part is a Laplacian pyramid of coarse grids G_s [(s+1)^3, c],
upsampled trilinearly to the finest dense scale F and concatenated into
P [(F+1)^3, Cd]; `build_mip_fold_table` folds P into one row of 8 corner
tuples per cell, [F^3, 8 * Cd]. The levels finer than F share one hashed
row [2^log2, n_mip * 8 * c] keyed by the finest level's cell. A sample reads
one fold row and one hash row and blends each level with its own fraction.

Inference encodes through a fold table built once (`build_mip_fold_table`).
Training encodes from the parameters under autograd, as `train_gather`
says: "corner8" fetches the 8 corner rows of the materialised volume,
"foldrow" folds the volume with the slice-stack and fetches one wide row,
and "foldrow_pallas" folds it with kernel K5 (ops/hopper/fold_build.py),
forward and backward; "pair", "quad" and "cube" fetch the 8 corners as 4, 2
or 1 windows of a window view of the volume (`corner_windows`). All six
compute the same function.

Hashes are computed in int64 and masked to 32 bits, so they equal the JAX
package's uint32 arithmetic. With a bfloat16 table the blend rounds as
JAX does: each weight * feature product to bfloat16, then the 8-corner sum
in float32, rounded once.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .hash_encoding import _blend, _blend_weights, _corner_bits, _prime_hash
from .hopper.fold_build import fold_build, fold_build_plain


@dataclass(frozen=True)
class MipFoldSpec:
    pyramid_scales: Tuple[int, ...] = (16, 32, 64, 128)
    pyramid_channels: int = 4          # channels per pyramid scale
    mip_scales: Tuple[int, ...] = (256, 512, 1024, 2048)
    mip_channels: int = 4              # channels per mip level
    log2_hashmap_size: int = 19
    fold_scale: int = 0                # 0: fold at the native dense scale

    @property
    def F(self) -> int:
        return self.fold_scale or self.pyramid_scales[-1]

    @property
    def F_native(self) -> int:
        return self.pyramid_scales[-1]

    @property
    def dense_channels(self) -> int:
        return len(self.pyramid_scales) * self.pyramid_channels

    @property
    def hash_rows(self) -> int:
        return 2 ** self.log2_hashmap_size

    @property
    def hash_width(self) -> int:
        return len(self.mip_scales) * 8 * self.mip_channels

    @property
    def output_dim(self) -> int:
        return self.dense_channels + len(self.mip_scales) * self.mip_channels

    def validate(self):
        for a, b in zip(self.pyramid_scales, self.pyramid_scales[1:]):
            if b % a:
                raise ValueError("pyramid scales must nest (each divides "
                                 "the next)")
        for s in self.mip_scales:
            if s % self.mip_scales[-1] and self.mip_scales[-1] % s:
                raise ValueError("mip scales must nest")
            if s <= self.F_native:
                raise ValueError("mip scales must exceed the dense scale")
        if self.fold_scale:
            for s in self.pyramid_scales:
                if s % self.fold_scale and self.fold_scale % s:
                    raise ValueError("fold_scale must nest with every "
                                     "pyramid scale")
            if self.fold_scale > self.F_native:
                raise ValueError("fold_scale cannot exceed the native "
                                 "dense scale")


def mip_fold_init(generator, spec: MipFoldSpec, std: float = 1e-4):
    """Uniform(-std, std) pyramid grids and hash-fold table (the reference
    table init, grid.py:133-135), drawn from `generator` on its device in
    the JAX package's order: the grids coarse to fine, then the table."""
    spec.validate()
    dev = generator.device

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=dev)
        return u * (2.0 * std) - std

    return {"pyramid": [uniform(((s + 1) ** 3, spec.pyramid_channels))
                        for s in spec.pyramid_scales],
            "hash": uniform((spec.hash_rows, spec.hash_width))}


def _upsample_axis(v, factor: int, axis: int):
    """Linear upsample of grid-point samples along one axis:
    (n + 1) points -> (n * factor + 1) points."""
    if factor == 1:
        return v
    n = v.shape[axis] - 1
    lo = v.narrow(axis, 0, n).unsqueeze(axis + 1)
    hi = v.narrow(axis, 1, n).unsqueeze(axis + 1)
    w = (torch.arange(factor, dtype=v.dtype, device=v.device) / factor
         ).reshape([1] * (axis + 1) + [factor] + [1] * (v.ndim - 1 - axis))
    seg = lo * (1 - w) + hi * w                      # [..., n, factor, ...]
    shape = list(v.shape)
    shape[axis] = n * factor
    return torch.cat([seg.reshape(shape), v.narrow(axis, n, 1)], dim=axis)


def materialize_dense(params, spec: MipFoldSpec, dtype=None):
    """Upsample and concatenate the pyramid into P [(F+1)^3, Cd]."""
    F = spec.F
    outs = []
    for g, s in zip(params["pyramid"], spec.pyramid_scales):
        v = g.reshape(s + 1, s + 1, s + 1, spec.pyramid_channels)
        if s <= F:
            f = F // s
            for axis in range(3):
                v = _upsample_axis(v, f, axis)
        else:   # reduced fold_scale: exact strided grid-point sampling
            k = s // F
            v = v[::k, ::k, ::k]
        outs.append(v)
    P = torch.cat(outs, dim=-1)
    if dtype is not None:
        P = P.to(dtype)
    return P.reshape((F + 1) ** 3, spec.dense_channels)


def _hash_rows_for(cell, spec: MipFoldSpec):
    """fast_hash (gridencoder.cu:36-51) of the finest-level cell coords
    [..., 3] -> rows [...] int64."""
    return _prime_hash(cell) % spec.hash_rows


# the grid axes (x, y, z) that each windowed fetch reads two points along;
# it reads both values of the other axes as separate windows
_WINDOW_AXES = {"pair": (2,), "quad": (1, 2), "cube": (0, 1, 2)}


def corner_windows(table, ci, F: int, Cd: int, mode: str):
    """The 8 trilinear corner rows of cells ci [N, 3] from the grid-point
    table [(F+1)^3, Cd], as [N, 2, 2, 2, Cd] indexed (x, y, z), through ONE
    indexed read of a window view of the table: `unfold` makes the view
    (no copy) whose element at a grid point is its 2-point window along the
    axes of `mode` ("pair": z; "quad": y, z; "cube": x, y, z); the read
    takes 4, 2 or 1 windows per cell (the JAX package's lax.gather slices
    (1,1,2), (1,2,2), (2,2,2)). Autograd's backward of the read and the
    view sums each window's cotangent back onto its grid points."""
    axes = _WINDOW_AXES[mode]
    view = table.reshape(F + 1, F + 1, F + 1, Cd)
    for axis in axes:
        view = view.unfold(axis, 2, 1)        # [..., Cd, 2 per axis]
    # the window starts of a cell: 0 or 1 along each other axis, (x, y)
    # order with y fastest
    free = [a for a in range(3) if a not in axes]
    starts = np.zeros((2 ** len(free), 3), np.int64)
    for j, a in enumerate(free):
        starts[:, a] = (np.arange(len(starts)) >> (len(free) - 1 - j)) & 1
    at = ci[:, None, :] + torch.as_tensor(starts, dtype=ci.dtype,
                                          device=ci.device)[None]  # [N,S,3]
    w = view[at[..., 0], at[..., 1], at[..., 2]]            # [N, S, Cd, 2..]
    return w.movedim(2, -1).reshape(ci.shape[0], 2, 2, 2, Cd)


def _dense_corner_fetch(dense_table, ci, F: int, Cd: int, mode: str):
    """The 8 trilinear corner rows [N, 8, Cd] (x fastest, `_corner_bits`
    order) of cells ci [N, 3] from the grid-point table [(F+1)^3, Cd]:
    one row per corner ("corner8"), or one read of 4, 2 or 1 windows per
    cell ("pair", "quad", "cube"; `corner_windows`). The values are the
    same; the modes differ in the reads made per sample, which
    scripts/bench_gather.py section H times."""
    if mode in _WINDOW_AXES:
        cube = corner_windows(dense_table, ci, F, Cd, mode)
        return cube.permute(0, 3, 2, 1, 4).reshape(ci.shape[0], 8, Cd)
    if mode != "corner8":
        raise ValueError(f"unknown dense gather mode {mode!r}")
    bits = torch.as_tensor(_corner_bits(3).astype(np.int64), device=ci.device)
    corner = ci[:, None, :] + bits[None]                       # [N, 8, 3]
    rows = (corner[..., 0] * (F + 1) + corner[..., 1]) * (F + 1) \
        + corner[..., 2]
    return dense_table[rows]


def mip_fold_encode(params, x, spec: MipFoldSpec, bound: float = 1.0,
                    fold_table=None, compute_dtype=None,
                    train_gather: str = "corner8"):
    """Encode positions x [..., 3] in [-bound, bound] -> [..., output_dim].
    Positions outside the box encode to zero.

    Inference: pass `fold_table` (from `build_mip_fold_table`): one fold
    row and one hash row per sample. Training: pass neither table; the
    dense part comes from params['pyramid'] under autograd, by
    `train_gather` ("corner8": the 8 corner rows of the materialised volume;
    "pair", "quad", "cube": the same corners as windows of it; "foldrow":
    the slice-stack fold and one wide row; "foldrow_pallas": the same fold
    through K5)."""
    prefix = x.shape[:-1]
    x = x.reshape(-1, 3)
    F = spec.F
    S = spec.mip_scales[-1]
    Cd = spec.dense_channels
    Cm = spec.mip_channels

    u = (x.float() + bound) / (2.0 * bound)
    oob = ((u < 0.0) | (u > 1.0)).any(dim=-1)

    # dense part: one fold row per sample
    pos = u * float(F)
    cell = torch.clamp(torch.floor(pos), 0.0, F - 1.0)
    frac = pos - cell
    ci = cell.to(torch.int64)
    if fold_table is None and train_gather in ("foldrow", "foldrow_pallas"):
        dt = compute_dtype if compute_dtype is not None \
            else params["pyramid"][0].dtype
        fold = fold_build if train_gather == "foldrow_pallas" \
            else fold_build_plain
        fold_table = fold(materialize_dense(params, spec, dtype=dt), F, Cd)
    if fold_table is not None:
        row = (ci[:, 0] * F + ci[:, 1]) * F + ci[:, 2]
        feats = fold_table[row].reshape(-1, 8, Cd)
    else:
        feats = _dense_corner_fetch(
            materialize_dense(params, spec, dtype=compute_dtype), ci, F, Cd,
            train_gather)
    outs = [_blend(_blend_weights(frac), feats)]

    # hash-fold part: one row keyed by the finest level's cell
    cell_s = torch.clamp(torch.floor(u * float(S)), 0.0,
                         S - 1.0).to(torch.int64)
    htab = params["hash"]
    if compute_dtype is not None:
        htab = htab.to(compute_dtype)
    hfeat = htab[_hash_rows_for(cell_s, spec)]
    hfeat = hfeat.reshape(-1, len(spec.mip_scales), 8, Cm)
    for li, s in enumerate(spec.mip_scales):
        delta = int(np.log2(S // s))
        cell_l = (cell_s >> delta).float()
        frac_l = torch.clamp(u * float(s) - cell_l, 0.0, 1.0)
        outs.append(_blend(_blend_weights(frac_l), hfeat[:, li]))

    out = torch.cat(outs, dim=-1)
    out = torch.where(oob[:, None], torch.zeros_like(out), out)
    return out.reshape(prefix + (spec.output_dim,))


def build_mip_fold_table(params, spec: MipFoldSpec, dtype=torch.bfloat16):
    """Fold the materialized dense volume into cell rows [F^3, 8 * Cd]
    (exact: P is piecewise trilinear on the F grid)."""
    return fold_build_plain(materialize_dense(params, spec, dtype=dtype),
                            spec.F, spec.dense_channels)
