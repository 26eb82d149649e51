"""Instance frames (``yhair_tpu/io/scene_json.py:frame_matrix`` and
``transform_segments``). The scene JSON reader and writer are not ported
yet; these two are what the instanced acceleration and its tests need.
"""

from __future__ import annotations

import numpy as np


def frame_matrix(frame):
    """yocto-style frame, 4 rows [x axis, y axis, z axis, origin] ->
    (M (3, 3) with the axes as columns, o (3,), s the uniform scale);
    points map as p' = M @ p + o. A non-uniform scale is refused: capsule
    radii would depend on direction."""
    f = np.asarray(frame, np.float64)
    if f.shape != (4, 3):
        raise ValueError(f"frame must be 4x3, got {f.shape}")
    M = np.stack([f[0], f[1], f[2]], axis=1)
    lens = np.linalg.norm(f[:3], axis=1)
    s = float(lens[0])
    if not np.allclose(lens, s, rtol=1e-4):
        raise ValueError(f"non-uniform instance scale {lens}")
    return M, f[3], s


def transform_segments(segs, frame):
    """Bake one instance: segments (p0, p1, r0, r1) posed by a frame."""
    M, o, s = frame_matrix(frame)
    p0, p1, r0, r1 = segs
    return (np.asarray(p0) @ M.T + o, np.asarray(p1) @ M.T + o,
            np.asarray(r0) * s, np.asarray(r1) * s)
