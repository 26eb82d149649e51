"""Ray - hair-segment intersection (``yhair_tpu/geometry/segments.py``).

``_closest_approach`` keeps the reference's per-axis operation order: it
is the arithmetic of the CUDA kernels (``csrc/intersect.cu``) and of the
integrator's recompute of the winning t, and near-ties at strand-vertex
junctions flip winners if the forms differ. The brute-force
``nearest_hit`` (``Scan`` in the integrator) is the parity target of the
cluster search.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.safemath import safe_normalize

INF = 1e30
_BIG_ID = 2 ** 31 - 1


class Segments(NamedTuple):
    """SoA polyline segments with per-vertex radius."""

    p0: torch.Tensor  # (S, 3)
    p1: torch.Tensor  # (S, 3)
    r0: torch.Tensor  # (S,)
    r1: torch.Tensor  # (S,)

    def to(self, device):
        return Segments(*(a.to(device) for a in self))


def _closest_approach(o, d, p0, p1):
    """Per (ray, segment) closest approach: (s ray param, u segment param
    in [0, 1], squared distance). Arguments broadcast over leading dims."""
    d2 = p1 - p0
    w0 = [o[..., ax] - p0[..., ax] for ax in range(3)]
    b = (d[..., 0] * d2[..., 0] + d[..., 1] * d2[..., 1]
         + d[..., 2] * d2[..., 2])
    c = (d2[..., 0] * d2[..., 0] + d2[..., 1] * d2[..., 1]
         + d2[..., 2] * d2[..., 2])
    dd = d[..., 0] * w0[0] + d[..., 1] * w0[1] + d[..., 2] * w0[2]
    e = d2[..., 0] * w0[0] + d2[..., 1] * w0[1] + d2[..., 2] * w0[2]
    denom = torch.clamp(c - b * b, min=1e-12)
    u = torch.clamp((e - b * dd) / denom, 0.0, 1.0)
    s = b * u - dd
    off0 = (o[..., 0] + s * d[..., 0]) - (p0[..., 0] + u * d2[..., 0])
    off1 = (o[..., 1] + s * d[..., 1]) - (p0[..., 1] + u * d2[..., 1])
    off2 = (o[..., 2] + s * d[..., 2]) - (p0[..., 2] + u * d2[..., 2])
    return s, u, off0 * off0 + off1 * off1 + off2 * off2


def nearest_hit(o, d, segs: Segments, t_min=1e-4, t_max=INF, chunk=2048,
                ids=None):
    """Closest hit over all segments, scanned in chunks of segments.

    o, d: (N, 3). -> (t (N,), idx (N,) int32, hit (N,) bool). ids (S,):
    tie-break keys; among bitwise-equal nearest t the smallest id wins
    (negative ids lose every tie). Passing the clusters' ``seg_index``
    gives the cluster kernels' (t, original id) rule exactly.
    """
    n, s_total = o.shape[0], segs.p0.shape[0]
    dev = o.device
    if ids is None:
        ids = torch.arange(s_total, dtype=torch.int32, device=dev)
    else:
        ids = ids.to(torch.int32)
        ids = torch.where(ids < 0, torch.full_like(ids, _BIG_ID), ids)
    best_t = torch.full((n,), INF, dtype=o.dtype, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    best_id = torch.full((n,), _BIG_ID, dtype=torch.int32, device=dev)
    o_b, d_b = o[:, None, :], d[:, None, :]
    for base in range(0, s_total, chunk):
        sl = slice(base, min(base + chunk, s_total))
        s, u, dist2 = _closest_approach(o_b, d_b, segs.p0[None, sl],
                                        segs.p1[None, sl])
        cr0, cr1 = segs.r0[sl], segs.r1[sl]
        r = cr0[None] + (cr1 - cr0)[None] * u
        ok = (dist2 <= r * r) & (s > t_min) & (s < t_max)
        s = torch.where(ok, s, torch.full_like(s, INF))
        t_local = s.min(-1).values
        idm = torch.where(s == t_local[:, None], ids[None, sl],
                          torch.full_like(s, _BIG_ID, dtype=torch.int32))
        id_local, i_local = idm.min(-1)
        has = t_local < INF
        closer = (t_local < best_t) | (
            has & (t_local == best_t) & (id_local < best_id))
        best_t = torch.where(closer, t_local, best_t)
        best_i = torch.where(closer, (base + i_local).to(torch.int32),
                             best_i)
        best_id = torch.where(closer, id_local, best_id)
    return best_t, best_i, best_t < INF


class Scan(NamedTuple):
    """The brute-force search over ``segs``, ``chunk`` segments a step
    (None where only its box is asked), answering ``scene.accel``'s
    questions. Its ``occluded``, ``winners`` and ``sort_box`` read only
    ``nearest`` and ``seg_index`` (original ids, -1 = padding): the
    clusters and the BVH share them."""

    segs: Segments
    chunk: int
    seg_index = None

    def nearest(self, o, d):
        return nearest_hit(o, d, self.segs, chunk=self.chunk)

    def occluded(self, o, d, limit):
        """True where the nearest hit lies before ``limit``."""
        t, _, hit = self.nearest(o, d)
        return hit & (t < limit)

    def winners(self, segments, seg_mat_id, idx):
        """The winners as stored: (segments, idx, their hair-material
        ids; 0 without segments)."""
        if not seg_mat_id.shape[0]:   # no strand segments to look up
            return segments, idx, torch.zeros_like(idx, dtype=torch.int32)
        return segments, idx, seg_mat_id[torch.clamp(
            idx.long(), 0, seg_mat_id.shape[0] - 1)]

    def sort_box(self, segments):
        """(lo, hi) of the real segments' endpoints, detached."""
        p0, p1 = segments.p0.detach(), segments.p1.detach()
        if self.seg_index is not None:
            real = self.seg_index >= 0
            p0, p1 = p0[real], p1[real]
        return (torch.minimum(p0.amin(0), p1.amin(0)),
                torch.maximum(p0.amax(0), p1.amax(0)))


class SegmentShade(NamedTuple):
    position: torch.Tensor  # (N, 3) on the strand axis
    tangent: torch.Tensor   # (N, 3) frame x
    frame_y: torch.Tensor   # (N, 3) width axis
    frame_z: torch.Tensor   # (N, 3) faces the viewer
    h: torch.Tensor         # (N,) offset across the width
    u: torch.Tensor         # (N,) param along the segment
    radius: torch.Tensor    # (N,)


def shade_info(o, d, t, idx, segs: Segments) -> SegmentShade:
    """Shading attributes of the winning segment of each ray (frame:
    x = tangent, z = viewer-facing perpendicular of -d, y = z x x)."""
    p0, p1 = segs.p0[idx], segs.p1[idx]
    r0, r1 = segs.r0[idx], segs.r1[idx]
    _, u, _ = _closest_approach(o, d, p0, p1)
    hit_pos = o + t[:, None] * d
    off = hit_pos - (p0 + u[:, None] * (p1 - p0))
    radius = r0 + (r1 - r0) * u
    tangent = safe_normalize(p1 - p0)
    z = safe_normalize(
        -(d - (d * tangent).sum(-1, keepdim=True) * tangent))
    y = torch.linalg.cross(z, tangent)
    h = torch.clamp((off * y).sum(-1) / torch.clamp(radius, min=1e-12),
                    -1.0, 1.0)
    return SegmentShade(position=hit_pos, tangent=tangent, frame_y=y,
                        frame_z=z, h=h, u=u, radius=radius)
