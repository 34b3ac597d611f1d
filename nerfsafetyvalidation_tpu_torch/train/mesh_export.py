"""The density field's iso-surface as a mesh: the port of the JAX package's
train/mesh_export.py (reference nerf/utils.py `extract_fields` /
`extract_geometry`, without mcubes or trimesh).

`extract_fields` probes the density on a resolution^3 grid in blocks of
S^3 points (each block one call of `query_func`, which may run on the
card); `_iso_surface` polygonises the grid on the host
with marching tetrahedra: each cell splits into 6 tetrahedra around its
main diagonal, every tetrahedron the surface crosses emits one or two
triangles, and a vertex is made once per crossed grid edge (its two end
points), so neighbouring cells share it. The vertices, the faces and
their order are the JAX package's: the port only skips, before expanding
them into tetrahedra, the cells the surface does not cross (they emit
nothing), which keeps the host's memory to the crossed cells.
"""

import numpy as np


def extract_fields(bound_min, bound_max, resolution, query_func, S=128):
    """query_func (float32 points [n, 3] -> n values, numpy) over a
    resolution^3 grid from bound_min to bound_max, in blocks of up to S^3
    points (utils.py:152-167). Returns [R, R, R] float32 (x, y, z)."""
    n_split = max(resolution // S, 1)
    xs, ys, zs = (np.array_split(np.linspace(bound_min[a], bound_max[a],
                                             resolution), n_split)
                  for a in range(3))
    u = np.zeros([resolution] * 3, dtype=np.float32)
    xo = 0
    for xb in xs:
        yo = 0
        for yb in ys:
            zo = 0
            for zb in zs:
                xx, yy, zz = np.meshgrid(xb, yb, zb, indexing="ij")
                pts = np.stack([xx.reshape(-1), yy.reshape(-1),
                                zz.reshape(-1)], axis=-1).astype(np.float32)
                u[xo:xo + len(xb), yo:yo + len(yb), zo:zo + len(zb)] = \
                    np.asarray(query_func(pts)).reshape(len(xb), len(yb),
                                                        len(zb))
                zo += len(zb)
            yo += len(yb)
        xo += len(xb)
    return u


# cube corners indexed by bits (x, y, z); 6 tetrahedra around diagonal 0-7
_CORNER_OFF = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                        for c in range(8)], dtype=np.int64)
_TETS = np.array([(0, 5, 1, 7), (0, 1, 3, 7), (0, 3, 2, 7),
                  (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7)], dtype=np.int64)


def _crossed_cells(inside):
    """[M, 3] int64 (i, j, k) of the cells whose 8 corners are neither all
    inside nor all outside, in raster order (x slowest)."""
    R = inside.shape[0]
    any_in = np.zeros((R - 1,) * 3, dtype=bool)
    all_in = np.ones((R - 1,) * 3, dtype=bool)
    for dx, dy, dz in _CORNER_OFF:
        c = inside[dx:dx + R - 1, dy:dy + R - 1, dz:dz + R - 1]
        any_in |= c
        all_in &= c
    return np.argwhere(any_in & ~all_in).astype(np.int64)


def _iso_surface(u, threshold):
    """Marching tetrahedra over the value grid u [R, R, R]. Returns (verts
    [V, 3] float64 in grid coordinates, faces [F, 3] int32), each triangle
    wound so that its normal points from inside (u > threshold) to
    outside."""
    R = u.shape[0]
    inside = u > threshold
    base = _crossed_cells(inside)                                 # [M, 3]
    corner_ijk = base[:, None, :] + _CORNER_OFF[None]             # [M, 8, 3]
    corner_gid = (corner_ijk[..., 0] * R + corner_ijk[..., 1]) * R \
        + corner_ijk[..., 2]                                      # [M, 8]
    flat_u = u.reshape(-1)
    flat_in = inside.reshape(-1)

    tet_gid = corner_gid[:, _TETS].reshape(-1, 4)                 # [T, 4]
    tet_in = flat_in[tet_gid]
    n_in = tet_in.sum(axis=1)
    active = (n_in > 0) & (n_in < 4)
    tet_gid, tet_in, n_in = tet_gid[active], tet_in[active], n_in[active]
    if tet_gid.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int32)

    # each tetrahedron's corners with the special ones first: the lone
    # inside corner (one in), the lone outside corner (three in), the two
    # inside corners (two in)
    key = np.where((n_in == 3)[:, None], tet_in, ~tet_in)  # False first
    order = np.argsort(key, axis=1, kind="stable")
    sg = np.take_along_axis(tet_gid, order, axis=1)

    tri_edges, tri_inref = [], []
    for m in (n_in == 1, n_in == 3):
        if not m.any():
            continue
        s = sg[m]            # s[:, 0] is the lone corner
        tri_edges.append(np.stack([np.stack([s[:, 0], s[:, k]], -1)
                                   for k in (1, 2, 3)], axis=1))
        tri_inref.append(s)
    two = n_in == 2
    if two.any():
        s = sg[two]          # s[:, :2] inside, s[:, 2:] outside
        quad = np.stack([np.stack([s[:, a], s[:, b]], -1)
                         for a, b in ((0, 2), (0, 3), (1, 3), (1, 2))],
                        axis=1)
        tri_edges += [quad[:, [0, 1, 2]], quad[:, [0, 2, 3]]]
        tri_inref += [s, s]
    edges = np.concatenate(tri_edges, axis=0)        # [F, 3, 2]
    refs = np.concatenate(tri_inref, axis=0)         # [F, 4]

    # one vertex per crossed grid segment, keyed by its two end points
    lo = np.minimum(edges[..., 0], edges[..., 1]).astype(np.int64)
    hi = np.maximum(edges[..., 0], edges[..., 1]).astype(np.int64)
    keys = (lo * (R ** 3) + hi).reshape(-1)
    _, first, idx_map = np.unique(keys, return_index=True,
                                  return_inverse=True)
    a_gid = edges.reshape(-1, 2)[first, 0]
    b_gid = edges.reshape(-1, 2)[first, 1]
    va = flat_u[a_gid].astype(np.float64)
    vb = flat_u[b_gid].astype(np.float64)
    t = np.clip((threshold - va) / np.where(vb != va, vb - va, 1.0),
                0.0, 1.0)

    def ijk(gid):
        return np.stack([gid // (R * R), (gid // R) % R, gid % R],
                        -1).astype(np.float64)

    pa, pb = ijk(a_gid), ijk(b_gid)
    verts = pa + t[:, None] * (pb - pa)
    faces = idx_map.reshape(-1, 3).astype(np.int32)

    # wind each triangle from its tetrahedron's inside corners outwards
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    normal = np.cross(p1 - p0, p2 - p0)
    w_in = flat_in[refs][..., None].astype(np.float64)
    pts = ijk(refs)
    cin = (pts * w_in).sum(1) / np.maximum(w_in.sum(1), 1)
    cout = (pts * (1 - w_in)).sum(1) / np.maximum((1 - w_in).sum(1), 1)
    flip = np.einsum("fd,fd->f", normal, cout - cin) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces


def extract_geometry(bound_min, bound_max, resolution, threshold,
                     query_func):
    """(vertices [V, 3] float32 in world coordinates, faces [F, 3] int32)
    of the `threshold` iso-surface of query_func (utils.py:170-182)."""
    u = extract_fields(bound_min, bound_max, resolution, query_func)
    verts, faces = _iso_surface(u, threshold)
    bound_min = np.asarray(bound_min, dtype=np.float64)
    bound_max = np.asarray(bound_max, dtype=np.float64)
    step = (bound_max - bound_min) / (resolution - 1)
    return ((bound_min + verts * step).astype(np.float32),
            faces.astype(np.int32))


def _rows_text(rows, prefix=""):
    """Each row of a [n, 3] array as `prefix` and its three numbers, space
    separated, one line each, the numbers as Python prints them (a
    float32 as the float64 it is exactly, which is how the JAX package's
    f-string prints a numpy float32): one repr of the nested list, cut
    into lines."""
    if len(rows) == 0:
        return ""
    text = repr(np.asarray(rows).tolist())[2:-2]
    return prefix + text.replace("], [", "\n" + prefix).replace(
        ", ", " ") + "\n"


def write_ply(path, verts, faces):
    """An ASCII .ply of the mesh, byte for byte the JAX package's."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        f.write(_rows_text(verts))
        f.write(_rows_text(faces, "3 "))
