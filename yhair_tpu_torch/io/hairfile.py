"""Cem Yuksel's .hair file format (``yhair_tpu/io/hairfile.py``;
cemyuksel.com/research/hairmodels).

  128-byte header:
    char[4]  magic "HAIR"
    uint32   num_strands
    uint32   num_points
    uint32   flags: bit0 segments array, bit1 points, bit2 thickness,
                    bit3 transparency, bit4 colors
    uint32   default_segments
    float    default_thickness
    float    default_transparency
    float[3] default_color
    char[88] info
  then, in order, the arrays whose flag bits are set:
    uint16[num_strands] segments, float[3*num_points] points,
    float[num_points] thickness, float[num_points] transparency,
    float[3*num_points] colors

``save`` writes the reference's bytes (its info string included), so a
file converted by either package is the same file.
"""

from __future__ import annotations

import struct

import numpy as np

_HEADER = struct.Struct("<4sIIIIff3f88s")


def load(path):
    """-> dict(points (P,3), thickness (P,), segments (S,) per strand)."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, n_strands, n_points, flags, d_segments, d_thick, _d_transp,
     *_rest) = _HEADER.unpack_from(data, 0)
    if magic != b"HAIR":
        raise ValueError(f"{path}: bad magic {magic!r}")
    off = _HEADER.size
    segments = None
    if flags & 1:
        segments = np.frombuffer(data, "<u2", n_strands, off).astype(np.int64)
        off += 2 * n_strands
    if not flags & 2:
        raise ValueError(f"{path}: no points array")
    points = np.frombuffer(data, "<f4", 3 * n_points, off).reshape(-1, 3)
    off += 12 * n_points
    thickness = None
    if flags & 4:
        thickness = np.frombuffer(data, "<f4", n_points, off).copy()
        off += 4 * n_points
    if segments is None:
        segments = np.full(n_strands, d_segments, np.int64)
    if thickness is None:
        thickness = np.full(n_points, d_thick, np.float32)
    return {"points": points.astype(np.float64),
            "thickness": thickness.astype(np.float64),
            "segments": segments}


def save(path, points, segments, thickness=None):
    """points (P,3); segments (S,) = per-strand segment counts."""
    points = np.asarray(points, np.float32)
    segments = np.asarray(segments, np.uint16)
    flags = 1 | 2
    if thickness is not None:
        flags |= 4
    header = _HEADER.pack(b"HAIR", len(segments), len(points), flags, 0,
                          float(thickness.mean()) if thickness is not None
                          else 1e-3,
                          0.0, 0.5, 0.3, 0.2, b"yhair_tpu export")
    with open(path, "wb") as f:
        f.write(header)
        f.write(segments.astype("<u2").tobytes())
        f.write(points.astype("<f4").reshape(-1).tobytes())
        if thickness is not None:
            f.write(np.asarray(thickness, "<f4").tobytes())


def to_segments(hair, radius_scale=1.0):
    """Flatten strands into the segment SoA (p0, p1, r0, r1).

    Each strand s has segments[s] segments => segments[s]+1 points,
    consecutive in the points array (the format's layout).
    """
    pts = hair["points"]
    th = hair["thickness"] * radius_scale
    counts = hair["segments"]
    # per-strand start offsets, then per-segment indices
    starts = np.concatenate([[0], np.cumsum(counts + 1)])[:-1]
    seg_first = np.concatenate(
        [np.arange(s, s + c) for s, c in zip(starts, counts)])
    i0 = seg_first
    i1 = seg_first + 1
    return pts[i0], pts[i1], th[i0] * 0.5, th[i1] * 0.5
