"""Host-side mesh shape operations, numpy, run once at scene build
(``yhair_tpu/geometry/shape_ops.py``): quads to triangles, vertex
normals, midpoint subdivision and displacement. The renderer's device
geometry stays the flat triangle table.

Meshes are the shared dict format: {positions (V,3), triangles (T,3),
normals (V,3) optional, quads (Q,4) optional}.
"""

from __future__ import annotations

import numpy as np


def quads_to_triangles(mesh):
    """Triangulate any 'quads' (Q, 4) into the triangle list, split
    along the shorter diagonal so non-planar quads keep their shape."""
    if "quads" not in mesh or len(mesh["quads"]) == 0:
        return mesh
    pos = np.asarray(mesh["positions"], np.float64)
    q = np.asarray(mesh["quads"], np.int64)
    d02 = np.linalg.norm(pos[q[:, 0]] - pos[q[:, 2]], axis=1)
    d13 = np.linalg.norm(pos[q[:, 1]] - pos[q[:, 3]], axis=1)
    use02 = d02 <= d13
    t1 = np.where(use02[:, None], q[:, [0, 1, 2]], q[:, [0, 1, 3]])
    t2 = np.where(use02[:, None], q[:, [0, 2, 3]], q[:, [1, 2, 3]])
    tris = np.asarray(mesh.get("triangles", np.zeros((0, 3), np.int64)),
                      np.int64).reshape(-1, 3)
    out = dict(mesh, triangles=np.concatenate([tris, t1, t2]))
    out.pop("quads")
    return out


def compute_normals(mesh):
    """Area-weighted vertex normals."""
    pos = np.asarray(mesh["positions"], np.float64)
    tri = np.asarray(mesh["triangles"], np.int64)
    fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]],
                  pos[tri[:, 2]] - pos[tri[:, 0]])
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, tri[:, k], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-300)
    return dict(mesh, normals=nrm)


def subdivide_mesh(mesh, levels=1):
    """Midpoint (1:4) triangle subdivision with shared-edge vertex
    dedup; normals recomputed. Linear, not Loop."""
    mesh = quads_to_triangles(mesh)
    pos = np.asarray(mesh["positions"], np.float64)
    tri = np.asarray(mesh["triangles"], np.int64)
    for _ in range(levels):
        edges = np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]],
                                tri[:, [2, 0]]])
        ekey = np.sort(edges, axis=1)
        uniq, inv = np.unique(ekey, axis=0, return_inverse=True)
        mid = 0.5 * (pos[uniq[:, 0]] + pos[uniq[:, 1]])
        m01 = pos.shape[0] + inv[:len(tri)]
        m12 = pos.shape[0] + inv[len(tri):2 * len(tri)]
        m20 = pos.shape[0] + inv[2 * len(tri):]
        pos = np.concatenate([pos, mid])
        tri = np.concatenate([
            np.stack([tri[:, 0], m01, m20], 1),
            np.stack([tri[:, 1], m12, m01], 1),
            np.stack([tri[:, 2], m20, m12], 1),
            np.stack([m01, m12, m20], 1)])
    return compute_normals(dict(mesh, positions=pos, triangles=tri))


def displace_mesh(mesh, height, scale=1.0):
    """Move vertices along their normals by a height field.

    height: callable(positions (V,3)) -> (V,) | array (V,) | a 2D
    array sampled by the vertices' (x, z) footprint (simple planar
    projection, the common displacement-map case)."""
    mesh = dict(mesh)
    if "normals" not in mesh:
        mesh = compute_normals(mesh)
    pos = np.asarray(mesh["positions"], np.float64)
    nrm = np.asarray(mesh["normals"], np.float64)
    if callable(height):
        hval = np.asarray(height(pos), np.float64)
    else:
        hmap = np.asarray(height, np.float64)
        if hmap.ndim >= 2:
            lo = pos.min(0)
            ext = np.maximum(pos.max(0) - lo, 1e-12)
            u = (pos[:, 0] - lo[0]) / ext[0]
            v = (pos[:, 2] - lo[2]) / ext[2]
            iy = np.clip((v * (hmap.shape[0] - 1)).round().astype(int),
                         0, hmap.shape[0] - 1)
            ix = np.clip((u * (hmap.shape[1] - 1)).round().astype(int),
                         0, hmap.shape[1] - 1)
            hval = hmap[iy, ix]
            if hval.ndim == 2:
                hval = hval.mean(-1)
        else:
            hval = hmap
    out = dict(mesh, positions=pos + scale * hval[:, None] * nrm)
    return compute_normals(out)
