"""Wavefront OBJ mesh IO (``yhair_tpu/io/obj.py``).

Supports v/vt/vn records, polygonal faces (fan-triangulated), negative
(relative) indices, and the face-corner forms `v`, `v/vt`, `v/vt/vn`,
`v//vn`. Per-corner vt/vn indices are resolved to per-POSITION
attributes (last write wins): the renderer keeps one attribute set per
vertex.

Returns the shared mesh-dict format ({'positions', 'triangles',
'normals', 'texcoords'}) that ``core.scene.from_dict`` reads.
"""

from __future__ import annotations

import numpy as np


def _resolve(idx, n):
    """OBJ index -> 0-based (negative = relative to current count)."""
    return idx - 1 if idx > 0 else n + idx


def load_mesh(path):
    """-> mesh dict {'positions', 'triangles', 'normals'?, 'texcoords'?}."""
    positions, normals_raw, texcoords_raw = [], [], []
    tris = []
    # per-position attribute slots (resolved from face corners)
    vn_of = {}
    vt_of = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals_raw.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                texcoords_raw.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                corners = []
                for c in parts[1:]:
                    sub = c.split("/")
                    vi = _resolve(int(sub[0]), len(positions))
                    if len(sub) > 1 and sub[1]:
                        vt_of[vi] = _resolve(int(sub[1]),
                                             len(texcoords_raw))
                    if len(sub) > 2 and sub[2]:
                        vn_of[vi] = _resolve(int(sub[2]),
                                             len(normals_raw))
                    corners.append(vi)
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tris.append([corners[0], corners[k], corners[k + 1]])
    positions = np.asarray(positions, np.float64)
    mesh = {"positions": positions,
            "triangles": np.asarray(tris, np.int64).reshape(-1, 3)}
    n = len(positions)
    if normals_raw and vn_of:
        nr = np.asarray(normals_raw, np.float64)
        vn = np.zeros((n, 3))
        for vi, ni in vn_of.items():
            vn[vi] = nr[ni]
        mesh["normals"] = vn
    if texcoords_raw and vt_of:
        tr = np.asarray(texcoords_raw, np.float64)
        vt = np.zeros((n, 2))
        for vi, ti in vt_of.items():
            vt[vi] = tr[ti]
        mesh["texcoords"] = vt
    return mesh


def save_mesh(path, positions, triangles, normals=None, texcoords=None):
    positions = np.asarray(positions, np.float64)
    triangles = np.asarray(triangles, np.int64)
    with open(path, "w") as f:
        f.write("# yhair_tpu OBJ export\n")
        for p in positions:
            f.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        if texcoords is not None:
            for t in np.asarray(texcoords, np.float64):
                f.write(f"vt {t[0]:.9g} {t[1]:.9g}\n")
        if normals is not None:
            for nv in np.asarray(normals, np.float64):
                f.write(f"vn {nv[0]:.9g} {nv[1]:.9g} {nv[2]:.9g}\n")
        has_t = texcoords is not None
        has_n = normals is not None
        for t in triangles:
            def corner(i):
                i1 = i + 1
                if has_t and has_n:
                    return f"{i1}/{i1}/{i1}"
                if has_t:
                    return f"{i1}/{i1}"
                if has_n:
                    return f"{i1}//{i1}"
                return str(i1)
            f.write(f"f {corner(t[0])} {corner(t[1])} {corner(t[2])}\n")
