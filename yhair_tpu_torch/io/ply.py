"""PLY strand and mesh IO (``yhair_tpu/io/ply.py``).

Hair polylines with a per-vertex radius, as line elements:

  element vertex N: float x, y, z, radius
  element line   M: int vertex1, vertex2        (2-vertex segments)

and triangle meshes (vertex x, y, z[, nx, ny, nz] + a face list). Reads
binary_little_endian and ascii; writes binary_little_endian, byte for
byte as the reference does. Loading strands returns the flat segment SoA
of ``geometry.segments.Segments``.
"""

from __future__ import annotations

import struct

import numpy as np


def save_strands(path, positions, radius, lines):
    """positions (V, 3) f32/f64, radius (V,), lines (E, 2) int."""
    positions = np.asarray(positions, np.float32)
    radius = np.asarray(radius, np.float32)
    lines = np.asarray(lines, np.int32)
    v = positions.shape[0]
    e = lines.shape[0]
    header = "\n".join([
        "ply",
        "format binary_little_endian 1.0",
        "comment yhair_tpu hair strands",
        f"element vertex {v}",
        "property float x",
        "property float y",
        "property float z",
        "property float radius",
        f"element line {e}",
        "property int vertex1",
        "property int vertex2",
        "end_header",
    ]) + "\n"
    vert = np.concatenate([positions, radius[:, None]], axis=1)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(vert.astype("<f4").tobytes())
        f.write(lines.astype("<i4").tobytes())


def load_strands(path):
    """-> (positions (V,3) f64, radius (V,), lines (E,2) i32)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(prop_type, prop_name), ...])
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property" and elements:
            if t[1] == "list":
                elements[-1][2].append(("list", t[2], t[3], t[4]))
            else:
                elements[-1][2].append((t[1], t[2]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "int": "<i4", "int32": "<i4", "uint": "<u4",
                "uchar": "u1", "uint8": "u1", "short": "<i2",
                "ushort": "<u2"}

    positions = radius = None
    lines_arr = None
    offset = 0

    def parse_ascii():
        nonlocal positions, radius, lines_arr
        rows = body.decode().split("\n")
        r = 0
        for name, count, props in elements:
            vals = []
            for _ in range(count):
                vals.append(rows[r].split())
                r += 1
            _assign(name, props, vals)

    def _assign(name, props, vals):
        nonlocal positions, radius, lines_arr
        arr = np.asarray(vals, np.float64)
        names = [p[1] for p in props if p[0] != "list"]
        if name == "vertex":
            ix = [names.index(k) for k in ("x", "y", "z")]
            positions = arr[:, ix]
            radius = (arr[:, names.index("radius")]
                      if "radius" in names else np.full(len(arr), 1e-3))
        elif name in ("line", "edge"):
            i1 = names.index("vertex1")
            i2 = names.index("vertex2")
            lines_arr = arr[:, [i1, i2]].astype(np.int32)

    if fmt == "ascii":
        parse_ascii()
    else:
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                # list properties: parse row by row (polyline strands)
                rows = []
                for _ in range(count):
                    row = []
                    for p in props:
                        if p[0] == "list":
                            cnt_t, val_t = type_map[p[1]], type_map[p[2]]
                            n = int(np.frombuffer(body, cnt_t, 1, offset)[0])
                            offset += np.dtype(cnt_t).itemsize
                            v = np.frombuffer(body, val_t, n, offset)
                            offset += n * np.dtype(val_t).itemsize
                            row.append(v)
                        else:
                            v = np.frombuffer(body, type_map[p[0]], 1, offset)
                            offset += np.dtype(type_map[p[0]]).itemsize
                            row.append(v[0])
                    rows.append(row)
                if name in ("line", "edge") and rows:
                    # list-form polylines -> split into 2-vertex segments
                    segs = []
                    for row in rows:
                        poly = row[0]
                        segs.extend(zip(poly[:-1], poly[1:]))
                    lines_arr = np.asarray(segs, np.int32)
                continue
            dt = np.dtype([(p[1], type_map[p[0]]) for p in props])
            arr = np.frombuffer(body, dt, count, offset)
            offset += count * dt.itemsize
            names = [p[1] for p in props]
            if name == "vertex":
                positions = np.stack([arr["x"], arr["y"], arr["z"]],
                                     axis=-1).astype(np.float64)
                radius = (arr["radius"].astype(np.float64)
                          if "radius" in names else np.full(count, 1e-3))
            elif name in ("line", "edge"):
                lines_arr = np.stack([arr["vertex1"], arr["vertex2"]],
                                     axis=-1).astype(np.int32)

    if positions is None or lines_arr is None:
        raise ValueError(f"{path}: missing vertex or line elements")
    return positions, radius, lines_arr


def lines_to_segments(positions, radius, lines):
    """-> (p0, p1, r0, r1) flat segment SoA."""
    i0, i1 = lines[:, 0], lines[:, 1]
    return (positions[i0], positions[i1], radius[i0], radius[i1])


def save_mesh(path, positions, triangles, normals=None):
    """Standard triangle-mesh PLY (binary little endian): vertex
    x,y,z[,nx,ny,nz] + face list."""
    positions = np.asarray(positions, np.float32)
    triangles = np.asarray(triangles, np.int32)
    v, t = positions.shape[0], triangles.shape[0]
    props = ["property float x", "property float y", "property float z"]
    vert = positions
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        vert = np.concatenate([positions,
                               np.asarray(normals, np.float32)], axis=1)
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         "comment yhair_tpu triangle mesh", f"element vertex {v}"]
        + props
        + [f"element face {t}", "property list uchar int vertex_indices",
           "end_header"]) + "\n"
    face = np.empty(t, np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    face["n"] = 3
    face["i"] = triangles
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(vert.astype("<f4").tobytes())
        f.write(face.tobytes())


def load_mesh(path):
    """-> mesh dict {positions (V,3) f64, triangles (T,3) i64,
    normals (V,3) f64 or None}. Polygon faces are fan-triangulated."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]

    fmt = None
    elements = []
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property" and elements:
            if t[1] == "list":
                elements[-1][2].append(("list", t[2], t[3], t[4]))
            else:
                elements[-1][2].append((t[1], t[2]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "int": "<i4", "int32": "<i4", "uint": "<u4",
                "uchar": "u1", "uint8": "u1", "short": "<i2",
                "ushort": "<u2"}
    positions = normals = None
    faces = []
    offset = 0

    def _vertex(arr, names):
        nonlocal positions, normals
        ix = [names.index(k) for k in ("x", "y", "z")]
        positions = arr[:, ix]
        if all(k in names for k in ("nx", "ny", "nz")):
            normals = arr[:, [names.index(k) for k in ("nx", "ny", "nz")]]

    if fmt == "ascii":
        rows = body.decode().split("\n")
        r = 0
        for name, count, props in elements:
            if name == "vertex":
                names = [p[1] for p in props]
                arr = np.asarray([rows[r + k].split()
                                  for k in range(count)], np.float64)
                _vertex(arr, names)
            elif name == "face":
                for k in range(count):
                    tok = rows[r + k].split()
                    faces.append([int(x) for x in tok[1:1 + int(tok[0])]])
            r += count
    else:
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            cnt_t, val_t = type_map[p[1]], type_map[p[2]]
                            n = int(np.frombuffer(body, cnt_t, 1,
                                                  offset)[0])
                            offset += np.dtype(cnt_t).itemsize
                            idx = np.frombuffer(body, val_t, n, offset)
                            offset += n * np.dtype(val_t).itemsize
                            if name == "face":
                                faces.append(idx.tolist())
                        else:
                            offset += np.dtype(type_map[p[0]]).itemsize
                continue
            dt = np.dtype([(p[1], type_map[p[0]]) for p in props])
            arr = np.frombuffer(body, dt, count, offset)
            offset += count * dt.itemsize
            if name == "vertex":
                names = [p[1] for p in props]
                _vertex(np.stack([arr[n2] for n2 in names],
                                 axis=-1).astype(np.float64), names)

    if positions is None or not faces:
        raise ValueError(f"{path}: missing vertex or face elements")
    tris = []
    for f_ in faces:
        for k in range(1, len(f_) - 1):      # fan triangulation
            tris.append((f_[0], f_[k], f_[k + 1]))
    return {"positions": positions,
            "triangles": np.asarray(tris, np.int64),
            "normals": normals}
