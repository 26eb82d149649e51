"""Ray - triangle-mesh intersection (``yhair_tpu/geometry/triangles.py``).

Moller-Trumbore with the reference's barycentric conventions. Every mesh
is flattened into one SoA buffer of gathered triangle vertices with a
per-triangle material id. The searches (``search``, ``occluded``) launch
``csrc/intersect.cu:tri_hit_kernel`` / ``tri_any_kernel`` for CUDA
tensors and run the plain twin ``_search`` for CPU tensors: torch ops
over chunks of rays and of triangles, so its (rays, triangles)
temporaries stay bounded (``RAY_CHUNK`` x ``chunk``). The winner is the
first triangle of least t, as the reference's per-chunk ``argmin``
gives; kernels and twin agree bit for bit. The search is discrete and
keeps no autograd graph: the winner's t is recomputed on the gathered
triangle (the reference differentiates through its scan; the value and
the gradient are the same). Shading attributes are recomputed for the
winning triangle only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..utils import trace

INF = 1e30
# rays per chunk of the search: (8192, 2048) f32 temporaries are 64 MB
RAY_CHUNK = 8192


class Triangles(NamedTuple):
    """SoA triangle soup: gathered vertices and per-vertex normals (the
    geometric normal where a mesh has none); mat_id indexes the scene's
    surface-material table."""

    v0: torch.Tensor      # (T, 3)
    v1: torch.Tensor      # (T, 3)
    v2: torch.Tensor      # (T, 3)
    n0: torch.Tensor      # (T, 3)
    n1: torch.Tensor      # (T, 3)
    n2: torch.Tensor      # (T, 3)
    uv0: torch.Tensor     # (T, 2) per-vertex texcoords (zeros = none)
    uv1: torch.Tensor     # (T, 2)
    uv2: torch.Tensor     # (T, 2)
    mat_id: torch.Tensor  # (T,) int32

    @property
    def n_triangles(self):
        return self.v0.shape[0]

    def to(self, device):
        return Triangles(*(a.to(device) for a in self))

    @classmethod
    def from_meshes(cls, meshes: list, mat_id0: int = 0,
                    device="cpu") -> "Triangles":
        """Flatten mesh dicts ({'positions', 'triangles', optional
        'normals', optional 'texcoords'}) into one buffer; mesh i gets
        material id mat_id0 + i."""
        vs, ns = [np.zeros((0, 3, 3))], [np.zeros((0, 3, 3))]
        uvs, mids = [np.zeros((0, 3, 2))], [np.zeros(0, np.int32)]
        for i, mesh in enumerate(meshes):
            pos = np.asarray(mesh["positions"], np.float64)
            tri = np.asarray(mesh["triangles"], np.int64)
            v = pos[tri]                            # (T, 3, 3)
            gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
            gn = gn / np.maximum(
                np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
            if mesh.get("normals") is not None:
                vn = np.asarray(mesh["normals"], np.float64)[tri]
            else:
                vn = np.broadcast_to(gn[:, None], v.shape)
            if mesh.get("texcoords") is not None:
                uv = np.asarray(mesh["texcoords"], np.float64)[tri]
            else:
                uv = np.zeros((len(tri), 3, 2))
            vs.append(v)
            ns.append(vn)
            uvs.append(uv)
            mids.append(np.full(len(tri), mat_id0 + i, np.int32))
        v, vn, uv = (np.concatenate(a).astype(np.float32)
                     for a in (vs, ns, uvs))

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)
        return cls(t(v[:, 0]), t(v[:, 1]), t(v[:, 2]),
                   t(vn[:, 0]), t(vn[:, 1]), t(vn[:, 2]),
                   t(uv[:, 0]), t(uv[:, 1]), t(uv[:, 2]),
                   t(np.concatenate(mids)))


def _mt(o, d, v0, v1, v2):
    """Moller-Trumbore over broadcastable (rays, tris), untested. ->
    (t, u, v, det)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pv = torch.linalg.cross(d, e2)
    det = (e1 * pv).sum(-1)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tv = o - v0
    u = (tv * pv).sum(-1) * inv
    qv = torch.linalg.cross(tv, e1)
    v = (d * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    return t, u, v, det


def _mt_hit(o, d, v0, v1, v2, t_min, t_max):
    """Moller-Trumbore over broadcastable (rays, tris). -> (t or INF,
    u, v)."""
    t, u, v, det = _mt(o, d, v0, v1, v2)
    ok = ((torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t > t_min) & (t < t_max))
    return torch.where(ok, t, INF), u, v


@torch.no_grad()
def _search(o, d, tris: Triangles, t_min, t_max, chunk):
    """(t or INF, idx int64) of the first triangle of least t."""
    with trace.span("yhair.triangles"):
        n, total = o.shape[0], tris.n_triangles
        t_out, i_out = [], []
        for lo in range(0, n, RAY_CHUNK):
            o_b = o[lo:lo + RAY_CHUNK, None, :]
            d_b = d[lo:lo + RAY_CHUNK, None, :]
            best_t = torch.full((o_b.shape[0],), INF, dtype=o.dtype,
                                device=o.device)
            best_i = torch.zeros((o_b.shape[0],), dtype=torch.int64,
                                 device=o.device)
            for base in range(0, total, chunk):
                sl = slice(base, base + chunk)
                t, _, _ = _mt_hit(o_b, d_b, tris.v0[None, sl],
                                  tris.v1[None, sl], tris.v2[None, sl],
                                  t_min, t_max)
                i_local = torch.argmin(t, -1)
                t_local = t.gather(-1, i_local[:, None])[:, 0]
                closer = t_local < best_t
                best_t = torch.where(closer, t_local, best_t)
                best_i = torch.where(closer, base + i_local, best_i)
            t_out.append(best_t)
            i_out.append(best_i)
        t = torch.cat(t_out) if t_out else o.new_zeros((0,))
        idx = torch.cat(i_out) if i_out else torch.zeros(
            (0,), dtype=torch.int64, device=o.device)
        return t, idx


def _count(o):
    if trace.enabled():
        trace.add("tri.rays", o.shape[0])
        if o.device.type != "cpu":
            trace.add("tri.rays_kernel", o.shape[0])


@torch.no_grad()
def search(o, d, tris: Triangles, t_min=1e-4, t_max=INF, chunk=2048):
    """(t or INF, idx int64) of the first triangle of least t in (t_min,
    t_max). CUDA tensors: one ``tri_hit_kernel`` launch; CPU tensors: the
    plain twin ``_search`` (``chunk`` triangles at a time). Both raise
    ValueError unless the inputs are contiguous float32 on one device."""
    kernels.check(1, o, d, *((v, torch.float32, (tris.n_triangles, 3))
                             for v in tris[:3]))
    _count(o)
    if o.device.type == "cpu":
        return _search(o, d, tris, t_min, t_max, chunk)
    with trace.span("yhair.triangles"):
        n = o.shape[0]
        t = torch.empty(n, dtype=torch.float32, device=o.device)
        idx = torch.empty(n, dtype=torch.int64, device=o.device)
        kernels.launch("yhair_tri_hit", o, d, tris.v0, tris.v1, tris.v2, n,
                       tris.n_triangles, t_min, t_max, t, idx)
        return t, idx


def nearest_hit(o, d, tris: Triangles, t_min=1e-4, t_max=INF, chunk=2048):
    """Closest hit over all triangles. o, d: (N, 3). -> (t (N,), idx (N,)
    int64, hit (N,) bool); among equal least t the first triangle wins.
    t is differentiable in the rays and the winning triangle."""
    t, idx = search(o, d, tris, t_min, t_max, chunk)
    hit = t < INF
    if not tris.n_triangles:
        return t, idx, hit
    t_re, _, _, _ = _mt(o, d, tris.v0[idx], tris.v1[idx], tris.v2[idx])
    return torch.where(hit, t_re, INF), idx, hit


@torch.no_grad()
def occluded(o, d, dist, tris: Triangles, t_min=1e-4, chunk=2048):
    """Shadow rays: whether the least t over the triangles in (t_min,
    INF), or INF where none, lies below dist * (1 - 1e-4). CUDA tensors:
    one ``tri_any_kernel`` launch; CPU tensors: the plain twin."""
    kernels.check(1, o, d, (dist, torch.float32, o.shape[:1]),
                  *((v, torch.float32, (tris.n_triangles, 3))
                    for v in tris[:3]))
    _count(o)
    if o.device.type == "cpu":
        t, _ = _search(o, d, tris, t_min, INF, chunk)
        return t < dist * (1.0 - 1e-4)
    with trace.span("yhair.triangles"):
        occ = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
        kernels.launch("yhair_tri_any", o, d, dist, tris.v0, tris.v1,
                       tris.v2, o.shape[0], tris.n_triangles, t_min, occ)
        return occ


class TriangleShade(NamedTuple):
    normal: torch.Tensor   # (N, 3) interpolated shading normal
    gnormal: torch.Tensor  # (N, 3) geometric normal
    mat_id: torch.Tensor   # (N,) int32
    uv: torch.Tensor       # (N, 2) interpolated texcoords


def _norm(v):
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def shade_info(o, d, idx, tris: Triangles) -> TriangleShade:
    """Shading attributes of the winning triangle of each ray."""
    v0, v1, v2 = tris.v0[idx], tris.v1[idx], tris.v2[idx]
    _, u, v = _mt_hit(o, d, v0, v1, v2, -INF, INF)
    gn = torch.linalg.cross(v1 - v0, v2 - v0)
    gn = gn / torch.clamp(_norm(gn), min=1e-20)
    w = 1.0 - u - v
    sn = (w[:, None] * tris.n0[idx] + u[:, None] * tris.n1[idx]
          + v[:, None] * tris.n2[idx])
    sn = sn / torch.clamp(_norm(sn), min=1e-12)
    # the shading normal stays on the geometric normal's side
    sn = sn * torch.where(((sn * gn).sum(-1) < 0)[:, None], -1.0, 1.0)
    uv = (w[:, None] * tris.uv0[idx] + u[:, None] * tris.uv1[idx]
          + v[:, None] * tris.uv2[idx])
    return TriangleShade(normal=sn, gnormal=gn, mat_id=tris.mat_id[idx],
                         uv=uv)
