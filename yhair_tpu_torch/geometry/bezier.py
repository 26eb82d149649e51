"""Ray - cubic Bezier intersection at a fixed depth
(``yhair_tpu/geometry/bezier.py``).

Every curve is evaluated at the 2^depth + 1 parameters of
``np.linspace(0, 1, 2^depth + 1)`` (float32, the reference's values) and
its chords are capsule-tested by the brute-force segment search, so the
leaf geometry is the tessellation's and gradients reach the four control
points. The search is discrete; the integrator re-evaluates the winning
chord from the control points differentiably.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.safemath import safe_normalize
from . import segments as seg

INF = seg.INF


def bezier_point(cp, t):
    """cp (..., 4, 3), t (...,) -> (..., 3)."""
    t = t[..., None]
    u = 1.0 - t
    return (u ** 3 * cp[..., 0, :] + 3 * u ** 2 * t * cp[..., 1, :]
            + 3 * u * t ** 2 * cp[..., 2, :] + t ** 3 * cp[..., 3, :])


def bezier_deriv(cp, t):
    t = t[..., None]
    u = 1.0 - t
    return 3.0 * (u ** 2 * (cp[..., 1, :] - cp[..., 0, :])
                  + 2 * u * t * (cp[..., 2, :] - cp[..., 1, :])
                  + t ** 2 * (cp[..., 3, :] - cp[..., 2, :]))


def _params(depth, like):
    """The 2^depth + 1 chord parameters, as the reference's float32."""
    ts = np.linspace(0.0, 1.0, (1 << depth) + 1, dtype=np.float32)
    return torch.as_tensor(ts, dtype=like.dtype, device=like.device)


def tessellate(cp, r0, r1, depth=3):
    """cp (C, 4, 3) -> per-chord (p0, p1 (C*L, 3); ra, rb (C*L,)), the
    radius lerped along the global curve parameter (the tessellation of
    ``bezier_to_segments(n_seg=2^depth)``)."""
    ts = _params(depth, cp)
    pts = bezier_point(cp[:, None, :, :], ts[None, :].expand(
        cp.shape[0], -1))                                 # (C, L+1, 3)
    rr = r0[:, None] + (r1 - r0)[:, None] * ts[None, :]   # (C, L+1)
    return (pts[:, :-1].reshape(-1, 3), pts[:, 1:].reshape(-1, 3),
            rr[:, :-1].reshape(-1), rr[:, 1:].reshape(-1))


def nearest_hit(o, d, cp, r0, r1, depth=3, t_min=1e-4, chunk=2048):
    """Closest hit of rays (R, 3) against curves cp (C, 4, 3).

    -> (t (R,), curve (R,) int32, u (R,) global curve parameter,
    hit (R,)); t is INF where nothing is hit."""
    n_leaf = 1 << depth
    p0, p1, ra, rb = tessellate(cp, r0, r1, depth)
    t, j, hit = seg.nearest_hit(o, d, seg.Segments(p0, p1, ra, rb),
                                t_min=t_min, chunk=chunk)
    # the winning chord's own parameter, then the curve's
    _, ul, _ = seg._closest_approach(o, d, p0[j], p1[j])
    curve = torch.div(j, n_leaf, rounding_mode="floor")
    leaf = (j % n_leaf).to(t.dtype)
    return torch.where(hit, t, INF), curve, (leaf + ul) / n_leaf, hit


def shade_frame(o, d, t, cp, curve, u):
    """The curve's frame at a hit: (position on the ray, tangent from the
    derivative at u, frame_y, frame_z, offset from the axis point)."""
    cpc = cp[curve]
    tan = safe_normalize(bezier_deriv(cpc, u), eps=1e-20)
    pos = o + t[:, None] * d
    off = pos - bezier_point(cpc, u)
    z = safe_normalize(-(d - (d * tan).sum(-1, keepdim=True) * tan),
                       eps=1e-20)
    return pos, tan, torch.linalg.cross(z, tan), z, off


def h_offset(off, frame_y, radius):
    h = (off * frame_y).sum(-1) / torch.clamp(radius, min=1e-20)
    return torch.clamp(h, -1.0, 1.0)
