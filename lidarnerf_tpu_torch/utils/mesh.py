"""Isosurface extraction and PLY export, numpy on the host (copy of lidarnerf_tpu/utils/mesh.py).

The density field is sampled in chunks through a query function (the
trainer's runs the network on the device), then triangulated on the host
with *marching tetrahedra*: each voxel splits into 6 tetrahedra whose 16
sign cases are derived analytically, so no 256-entry lookup table is needed
and the surface is consistent across faces. Output is an ASCII PLY.
"""

import numpy as np

# Cube corners in the conventional (Bourke) ordering: bottom face CCW then top
# face CCW, so corner 6 = (1,1,1) is the main-diagonal opposite of corner 0.
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ]
)

# 6-tetrahedra decomposition sharing the 0-6 main diagonal; the third pair of
# corners walks the cycle (5,1,2,3,7,4) so the tets tile the cube exactly.
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ]
)


def _interp(p0, p1, v0, v1, iso):
    """Linear interpolation of the iso crossing on an edge. [..., 3]"""
    denom = v1 - v0
    t = np.where(np.abs(denom) > 1e-12, (iso - v0) / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)[..., None]
    return p0 + t * (p1 - p0)


def marching_tetrahedra(volume, iso):
    """Triangulate the iso-surface of a dense [X, Y, Z] scalar field.

    Returns (vertices [V, 3] in index coordinates, triangles [T, 3] int).
    Vertices are emitted per-triangle (deduplication is unnecessary for PLY
    export and keeps this fully vectorised).
    """
    vol = np.asarray(volume, np.float64)
    X, Y, Z = vol.shape
    # corner values per cube: [X-1, Y-1, Z-1, 8]
    cv = np.stack(
        [
            vol[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz]
            for dx, dy, dz in _CORNERS
        ],
        axis=-1,
    )
    inside = cv > iso
    active = inside.any(-1) & (~inside.all(-1))
    idx = np.argwhere(active)  # [M, 3] cube base coords
    if len(idx) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    vals = cv[active]  # [M, 8]
    base = idx.astype(np.float64)  # [M, 3]
    corner_pos = base[:, None, :] + _CORNERS[None, :, :]  # [M, 8, 3]

    tris = []
    for tet in _TETS:
        tv = vals[:, tet]  # [M, 4]
        tp = corner_pos[:, tet, :]  # [M, 4, 3]
        ins = tv > iso  # [M, 4]
        n_in = ins.sum(-1)

        # --- one corner inside (or one outside): single triangle
        for flip in (False, True):
            count = 1 if not flip else 3
            sel = n_in == count
            if not sel.any():
                continue
            svals, spos, sins = tv[sel], tp[sel], ins[sel]
            if flip:
                sins = ~sins
            apex = np.argmax(sins, axis=-1)  # the lone inside corner
            # indices of the three corners that are NOT apex
            all_idx = np.broadcast_to(np.arange(4), sins.shape)
            others = all_idx[all_idx != apex[:, None]].reshape(-1, 3)
            ap = np.take_along_axis(spos, apex[:, None, None].repeat(3, -1), 1)[:, 0]
            av = np.take_along_axis(svals, apex[:, None], 1)[:, 0]
            verts = []
            for k in range(3):
                op = np.take_along_axis(
                    spos, others[:, k][:, None, None].repeat(3, -1), 1
                )[:, 0]
                ov = np.take_along_axis(svals, others[:, k][:, None], 1)[:, 0]
                verts.append(_interp(ap, op, av, ov, iso))
            tris.append(np.stack(verts, axis=1))  # [m, 3, 3]

        # --- two corners inside: quad -> two triangles
        sel = n_in == 2
        if sel.any():
            svals, spos, sins = tv[sel], tp[sel], ins[sel]
            order = np.argsort(~sins, axis=-1)  # inside first
            i0, i1 = order[:, 0], order[:, 1]
            o0, o1 = order[:, 2], order[:, 3]

            def gp(ii):
                return np.take_along_axis(spos, ii[:, None, None].repeat(3, -1), 1)[:, 0]

            def gv(ii):
                return np.take_along_axis(svals, ii[:, None], 1)[:, 0]

            e00 = _interp(gp(i0), gp(o0), gv(i0), gv(o0), iso)
            e01 = _interp(gp(i0), gp(o1), gv(i0), gv(o1), iso)
            e10 = _interp(gp(i1), gp(o0), gv(i1), gv(o0), iso)
            e11 = _interp(gp(i1), gp(o1), gv(i1), gv(o1), iso)
            tris.append(np.stack([e00, e01, e10], axis=1))
            tris.append(np.stack([e01, e11, e10], axis=1))

    tri_pts = np.concatenate(tris, axis=0)  # [T, 3, 3]
    vertices = tri_pts.reshape(-1, 3)
    triangles = np.arange(len(vertices)).reshape(-1, 3)
    return vertices, triangles


def extract_fields(bound_min, bound_max, resolution, query_func, S=128):
    """Chunked density-grid sampling: an [R, R, R] float32 field of query_func."""
    u = np.zeros((resolution, resolution, resolution), np.float32)
    xs = np.linspace(bound_min[0], bound_max[0], resolution)
    ys = np.linspace(bound_min[1], bound_max[1], resolution)
    zs = np.linspace(bound_min[2], bound_max[2], resolution)
    for xi in range(0, resolution, S):
        for yi in range(0, resolution, S):
            for zi in range(0, resolution, S):
                xx, yy, zz = np.meshgrid(
                    xs[xi : xi + S], ys[yi : yi + S], zs[zi : zi + S], indexing="ij"
                )
                pts = np.stack(
                    [xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], axis=-1
                ).astype(np.float32)
                val = np.asarray(query_func(pts)).reshape(xx.shape)
                u[xi : xi + xx.shape[0], yi : yi + xx.shape[1], zi : zi + xx.shape[2]] = val
    return u


def extract_geometry(bound_min, bound_max, resolution, threshold, query_func):
    """Sample the field, triangulate it, and map the vertices to world coordinates."""
    u = extract_fields(bound_min, bound_max, resolution, query_func)
    vertices, triangles = marching_tetrahedra(u, threshold)
    b_min = np.asarray(bound_min)
    b_max = np.asarray(bound_max)
    vertices = vertices / (resolution - 1.0) * (b_max - b_min)[None, :] + b_min[None, :]
    return vertices, triangles


def export_ply(path, vertices, triangles):
    """Minimal ASCII PLY writer (replaces trimesh.export)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(triangles)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in vertices:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
