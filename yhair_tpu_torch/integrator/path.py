"""Wavefront path tracer (``yhair_tpu/integrator/path.py``).

Camera rays -> bounce loop { intersect -> environment and emission ->
next-event estimation with shadow rays (point lights, the environment
map, area lights) -> BSDF sample -> Russian roulette }, over a fixed
depth with alive masks; the reference's ``lax.scan`` is a Python loop
here. It consumes the oracle's uniforms layout and matches
``yhair_tpu``'s ``trace`` (samplers "path", "naive" and "eyelight") on
scenes of hair segments (flat, clustered or posed instances of one
cluster build), first-class Bezier curves, per-shape hair materials,
spheres, planes, triangle meshes, point and area lights, a constant
environment or an environment map, and textures, with hard or soft
strand silhouettes (``edge_softness``). Light samples and BSDF samples
are combined by the power heuristic; each bounce carries its BSDF
sample's pdf and delta flag to the next, in the rays' own order (only
the search sees the Morton sort).

The hit searches are discrete and run on detached rays; the winner is
then recomputed in closed form from the live geometry (the segment's,
the posed instance's or the curve's chord, ``where(hit, s_re, t)``), so
no kernel needs a backward. On the card the CUDA kernels' t is bit-equal
to the recompute of a flat scene, which keeps the two in step.

Gradients use detached sampling, as the reference does: sampled
directions, their pdf and Russian roulette's continuation probability
are detached, and the throughput f |cos| / pdf carries the gradient to
the hair parameters and, through the recomputed hit, to strand
endpoints, radii and control points. Soft silhouettes add the boundary
term the detached hit test drops (see ``trace``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..bsdf import hair as th
from ..bsdf import surface as ts
from ..core.camera import Camera, camera_rays
from ..core.envmap import env_eval, env_pdf, env_sample, has_env
from ..core.rng import D_BOUNCE, D_PIXEL
from ..core.safemath import safe_normalize
from ..core.scene import Scene
from ..core.texture import apply_textures, sample_bilinear
from ..device import resolve_device
from ..geometry import bezier as bez
from ..geometry import segments as seg
from ..geometry import triangles as tri
from ..utils import trace as tracing

INF = seg.INF
RR_START = 3
# subdivision depth of first-class Bezier curves (2^3 chords per curve,
# the tessellation of scenes.generators)
CURVE_DEPTH = 3


class Hit(NamedTuple):
    hit: torch.Tensor       # (N,) bool
    t: torch.Tensor         # (N,)
    mat: torch.Tensor       # (N,) int32: -1 miss, 0 hair, 1 surface
    mat_id: torch.Tensor    # (N,) int32 into scene.surf_mat (surface hits)
    light_id: torch.Tensor  # (N,) int32 area-light element id, -1 = none
    position: torch.Tensor  # (N, 3)
    normal: torch.Tensor    # (N, 3) surface shading normal
    gnormal: torch.Tensor   # (N, 3) geometric normal (area-light MIS pdf)
    tangent: torch.Tensor   # (N, 3) hair frame x
    frame_y: torch.Tensor   # (N, 3)
    frame_z: torch.Tensor   # (N, 3)
    h: torch.Tensor         # (N,)
    radius: torch.Tensor    # (N,)
    uv: torch.Tensor        # (N, 2) texture coordinates (surface hits)
    hair_mid: torch.Tensor  # (N,) int32 hair-material table index


def _permuted(fn, perm, *args):
    """fn(*args) evaluated on the rays in ``perm`` order, results returned
    in the original order. Only the search sees the sorted wavefront, so
    128-ray blocks are coherent while every shading op keeps its rays in
    place (per-ray search results do not depend on block composition)."""
    if perm is None:
        return fn(*args)
    outs = fn(*(a[perm] for a in args))
    if isinstance(outs, torch.Tensor):
        outs = (outs,)
    back = []
    for x in outs:
        y = torch.empty_like(x)
        y[perm] = x
        back.append(y)
    return back[0] if len(back) == 1 else tuple(back)


def _accel(scene: Scene, chunk):
    """The segment search: scene.accel, else the brute-force scan."""
    if scene.accel is None:
        return seg.Scan(scene.segments, chunk)
    return scene.accel


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _sphere_t(scene: Scene, o, d):
    """(N, NS) entry distances over the spheres (INF where missed)."""
    oc = o[:, None, :] - scene.sph_center[None]
    b = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - scene.sph_radius[None] ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    return torch.where((disc >= 0) & (t0 > 1e-4), t0,
                       torch.where((disc >= 0) & (t1 > 1e-4), t1, INF))


def _plane_t(scene: Scene, o, d):
    """(N, NP) plane distances (INF where parallel or behind)."""
    denom = (d[:, None, :] * scene.pln_normal[None]).sum(-1)
    tp = ((scene.pln_point[None] - o[:, None, :])
          * scene.pln_normal[None]).sum(-1) / torch.where(
        torch.abs(denom) < 1e-12, 1e-12, denom)
    return torch.where((torch.abs(denom) > 1e-9) & (tp > 1e-4), tp, INF)


def _sphere_uv(n):
    """Spherical uv of outward unit normals n (N, 3)."""
    return torch.stack(
        [torch.atan2(n[:, 2], n[:, 0]) / (2.0 * math.pi) + 0.5,
         torch.acos(torch.clamp(n[:, 1], -1.0, 1.0)) / math.pi], -1)


def _curve_hit(scene: Scene, o, d, chunk):
    """Detached nearest curve hit: (t, curve, u, hit)."""
    return bez.nearest_hit(o.detach(), d.detach(), scene.crv_cp.detach(),
                           scene.crv_r0.detach(), scene.crv_r1.detach(),
                           depth=CURVE_DEPTH, chunk=min(chunk, 512))


def intersect_scene(scene: Scene, o, d, chunk=2048, perm=None) -> Hit:
    """Closest hit over hair segments, curves, spheres, planes and
    triangles."""
    with tracing.span("yhair.search"):
        return _intersect(scene, o, d, chunk, perm)


def _intersect(scene: Scene, o, d, chunk, perm) -> Hit:
    n = o.shape[0]
    accel = _accel(scene, chunk)
    # the search is a discrete argmin: it sees detached rays
    t_seg, idx, hit_seg = _permuted(accel.nearest, perm, o.detach(),
                                    d.detach())
    t_seg, idx = t_seg.detach(), idx.detach()
    # each winner is recomputed below from the live geometry, as the
    # segment the shading reads (segs_view[idx_view])
    segs_view, idx_view, hair_mid = accel.winners(
        scene.segments, scene.seg_mat_id, idx)
    if scene.n_curves:
        # the winning chord, re-evaluated from the control points
        t_c, cidx, u_c, hit_c = _curve_hit(scene, o, d, chunk)
        crv_win = hit_c & (~hit_seg | (t_c < t_seg))
        n_leaf = 1 << CURVE_DEPTH
        leaf = torch.clamp((u_c * n_leaf).to(torch.int32), 0, n_leaf - 1)
        ta = leaf.to(o.dtype) / n_leaf
        tb = (leaf + 1).to(o.dtype) / n_leaf
        cpc = scene.crv_cp[cidx]
        cr0, cr1 = scene.crv_r0[cidx], scene.crv_r1[cidx]
        if segs_view.p0.shape[0]:
            sp0, sp1 = segs_view.p0[idx_view], segs_view.p1[idx_view]
            sr0, sr1 = segs_view.r0[idx_view], segs_view.r1[idx_view]
        else:   # curves only: a non-degenerate placeholder (a zero-length
            # segment NaNs the frame's gradient through unselected lanes)
            sp0 = o.new_zeros((n, 3))
            sp1 = sp0 + o.new_tensor([[1.0, 0.0, 0.0]])
            sr0 = sr1 = o.new_zeros((n,))
        cw = crv_win[:, None]
        # the radius lerps along the global curve parameter
        segs_view = seg.Segments(
            torch.where(cw, bez.bezier_point(cpc, ta), sp0),
            torch.where(cw, bez.bezier_point(cpc, tb), sp1),
            torch.where(crv_win, cr0 + (cr1 - cr0) * ta, sr0),
            torch.where(crv_win, cr0 + (cr1 - cr0) * tb, sr1))
        idx_view = torch.arange(n, device=o.device)
        hair_mid = torch.where(crv_win, scene.crv_mat_id[cidx], hair_mid)
        t_seg = torch.where(crv_win, t_c, t_seg)
        hit_seg = hit_seg | crv_win
    if segs_view.p0.shape[0]:
        # differentiable in the geometry (bit-equal to the CUDA kernels'
        # t on the card for flat clusters)
        s_re, _, _ = seg._closest_approach(o, d, segs_view.p0[idx_view],
                                           segs_view.p1[idx_view])
        t_seg = torch.where(hit_seg, s_re, t_seg)
    else:   # no strand geometry at all: a non-degenerate placeholder
        segs_view = seg.Segments(o.new_zeros((1, 3)),
                                 o.new_tensor([[1.0, 0.0, 0.0]]),
                                 o.new_zeros((1,)), o.new_zeros((1,)))
        idx_view = torch.zeros((n,), dtype=torch.int64, device=o.device)

    best_t = torch.where(hit_seg, t_seg, INF)
    mat = torch.where(hit_seg, 0, -1).to(torch.int32)
    mat_id = torch.zeros((n,), dtype=torch.int32, device=o.device)
    light_id = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    normal = torch.zeros_like(o)
    gnormal = torch.zeros_like(o)
    uv = o.new_zeros((n, 2))

    if scene.n_spheres:
        t_cand = _sphere_t(scene, o, d)
        i_s = torch.argmin(t_cand, -1)
        t_s = t_cand.gather(-1, i_s[:, None])[:, 0]
        closer = t_s < best_t
        best_t = torch.where(closer, t_s, best_t)
        mat = torch.where(closer, 1, mat)
        mat_id = torch.where(closer, i_s.to(torch.int32), mat_id)
        n_s = (o + t_s[:, None] * d) - scene.sph_center[i_s]
        n_s = n_s / torch.clamp(_norm(n_s)[:, None], min=1e-12)
        normal = torch.where(closer[:, None], n_s, normal)
        gnormal = torch.where(closer[:, None], n_s, gnormal)
        uv = torch.where(closer[:, None], _sphere_uv(n_s), uv)
        if scene.n_area_lights:
            light_id = torch.where(closer, scene.sph_light_id[i_s], light_id)

    if scene.n_planes:
        tp = _plane_t(scene, o, d)
        i_p = torch.argmin(tp, -1)
        t_p = tp.gather(-1, i_p[:, None])[:, 0]
        closer = t_p < best_t
        best_t = torch.where(closer, t_p, best_t)
        mat = torch.where(closer, 1, mat)
        mat_id = torch.where(closer, (scene.n_spheres + i_p).to(torch.int32),
                             mat_id)
        pn = scene.pln_normal[i_p]
        normal = torch.where(closer[:, None], pn, normal)
        gnormal = torch.where(closer[:, None], pn, gnormal)
        # planar uv in the stored normal's tangent frame (never the
        # flipped shading normal)
        pnu = pn / torch.clamp(_norm(pn)[:, None], min=1e-12)
        t1p = torch.linalg.cross(pnu, torch.where(
            torch.abs(pnu[:, 0:1]) > 0.9, pn.new_tensor([[0.0, 1.0, 0.0]]),
            pn.new_tensor([[1.0, 0.0, 0.0]])))
        t1p = t1p / torch.clamp(_norm(t1p)[:, None], min=1e-12)
        t2p = torch.linalg.cross(pnu, t1p)
        rel = (o + t_p[:, None] * d) - scene.pln_point[i_p]
        uv_p = torch.stack([(rel * t1p).sum(-1), (rel * t2p).sum(-1)], -1)
        uv = torch.where(closer[:, None], uv_p, uv)
        # planes are never lights: clear a sphere's light_id they occlude
        light_id = torch.where(closer, -1, light_id)

    if scene.n_triangles:
        t_t, i_t, hit_t = tri.nearest_hit(o, d, scene.tris, chunk=chunk)
        closer = torch.where(hit_t, t_t, INF) < best_t
        best_t = torch.where(closer, t_t, best_t)
        mat = torch.where(closer, 1, mat)
        tsh = tri.shade_info(o, d, i_t, scene.tris)
        mat_id = torch.where(closer, tsh.mat_id, mat_id)
        normal = torch.where(closer[:, None], tsh.normal, normal)
        gnormal = torch.where(closer[:, None], tsh.gnormal, gnormal)
        uv = torch.where(closer[:, None], tsh.uv, uv)
        if scene.n_area_lights:
            light_id = torch.where(closer, scene.tri_light_id[i_t], light_id)

    hit = best_t < INF
    is_hair = hit & (mat == 0)
    sh = seg.shade_info(o, d, torch.where(is_hair, best_t, 0.0), idx_view,
                        segs_view)
    pos = o + torch.where(hit, best_t, 0.0)[:, None] * d
    return Hit(hit=hit, t=torch.where(hit, best_t, INF), mat=mat,
               mat_id=mat_id, light_id=light_id,
               position=torch.where(is_hair[:, None], sh.position, pos),
               normal=normal, gnormal=gnormal, tangent=sh.tangent,
               frame_y=sh.frame_y, frame_z=sh.frame_z,
               h=torch.where(is_hair, sh.h, 0.0),
               radius=torch.where(is_hair, sh.radius, 0.0), uv=uv,
               hair_mid=hair_mid)


def occluded_scene(scene: Scene, o, d, dist, chunk=2048, perm=None):
    """Shadow rays: True where something lies before dist * (1 - 1e-4).
    Occlusion is boolean, so its inputs are detached."""
    with tracing.span("yhair.search"):
        o, d, dist = o.detach(), d.detach(), dist.detach()
        limit = dist * (1.0 - 1e-4)
        occ = _permuted(_accel(scene, chunk).occluded, perm, o, d, limit)
        if scene.n_curves:
            t_c, _, _, hit_c = _curve_hit(scene, o, d, chunk)
            occ = occ | (hit_c & (t_c < limit))
        if scene.n_spheres:
            occ = occ | (_sphere_t(scene, o, d).amin(-1) < limit)
        if scene.n_planes:
            occ = occ | (_plane_t(scene, o, d).amin(-1) < limit)
        if scene.n_triangles:
            occ = occ | tri.occluded(o, d, dist, scene.tris, chunk=chunk)
        return occ


def _morton_spread3(x):
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _ray_sort_perm(o, d, alive, lo, inv_ext):
    """Coherence permutation of a wavefront: by (Morton cell of origin,
    direction octant), dead rays last, so a 128-ray block lists few
    clusters (after one bounce the rays of a block otherwise scatter
    over the whole asset)."""
    q = torch.clamp((o - lo) * inv_ext, 0.0, 1.0)
    cell = (q * 1023.0).to(torch.int32)          # 10 bits per axis
    m = ((_morton_spread3(cell[:, 0]) << 2)
         | (_morton_spread3(cell[:, 1]) << 1)
         | _morton_spread3(cell[:, 2]))
    # position-major: the top 18 Morton bits, then the octant
    key = ((m >> 12) << 3) | ((d[:, 0] > 0).to(torch.int32)
                              + 2 * (d[:, 1] > 0).to(torch.int32)
                              + 4 * (d[:, 2] > 0).to(torch.int32))
    key = torch.where(alive, key, 1 << 29)
    return torch.argsort(key, stable=True)


def _sort_bounds(scene: Scene):
    """Box of the real segments for the Morton sort (``sort_box``). The
    padding segments of the clusters and of the BVH (at 1e8) are left
    out: the reference's bounds include them, which collapses every
    origin into Morton cell 0 (octant-only sort). For instances, the
    posed bounding sphere of that box."""
    lo, hi = _accel(scene, None).sort_box(scene.segments)
    return lo, 1.0 / torch.clamp(hi - lo, min=1e-6)


def _area_light_point(scene: Scene, el, u0, u1):
    """A point on area-light element el. -> (point, normal, uv)."""
    kind = scene.al_kind[el]
    p0, p1, p2 = scene.al_p0[el], scene.al_p1[el], scene.al_p2[el]
    su = torch.sqrt(torch.clamp(u0, min=0.0))
    w1 = su * (1.0 - u1)
    w2 = su * u1
    w0 = 1.0 - w1 - w2
    p_tri = w0[:, None] * p0 + w1[:, None] * p1 + w2[:, None] * p2
    n_tri = torch.linalg.cross(p1 - p0, p2 - p0)
    n_tri = n_tri / torch.clamp(_norm(n_tri)[:, None], min=1e-20)
    uv_tri = (w0[:, None] * scene.al_uv0[el] + w1[:, None] * scene.al_uv1[el]
              + w2[:, None] * scene.al_uv2[el])
    z = 1.0 - 2.0 * u0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u1
    n_sph = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    p_sph = p0 + n_sph * p1[:, 0:1]
    is_tri = (kind == 0)[:, None]
    return (torch.where(is_tri, p_tri, p_sph),
            torch.where(is_tri, n_tri, n_sph),
            torch.where(is_tri, uv_tri, _sphere_uv(n_sph)))


def _area_light_pdf_sa(scene: Scene, el, pos, lpos, lnrm):
    """Solid-angle pdf of area-light NEE reaching lpos from pos."""
    to_l = lpos - pos
    dist2 = (to_l * to_l).sum(-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-24))
    cos_l = torch.abs((lnrm * to_l).sum(-1)) / dist
    return (scene.al_pmf[el] * dist2
            / torch.clamp(cos_l * scene.al_area[el], min=1e-12))


def _mis(a, b):
    """The power heuristic's weight of the strategy with pdf a."""
    return a ** 2 / torch.clamp(a ** 2 + b ** 2, min=1e-30)


def _hair_kernel_route(x):
    """Whether a bounce's hair BSDF runs as one CUDA launch: on tensors on
    the card with autograd off (``progressive_render`` and ``render_fn``
    are ``no_grad``); the inverse steps' passes differentiate the torch
    code."""
    return x.is_cuda and not torch.is_grad_enabled()


def _diffuse_frame(nrm):
    a = torch.where(torch.abs(nrm[:, 0:1]) > 0.9,
                    nrm.new_tensor([[0.0, 1.0, 0.0]]),
                    nrm.new_tensor([[1.0, 0.0, 0.0]]))
    t1 = safe_normalize(torch.linalg.cross(nrm, a))
    return t1, torch.linalg.cross(nrm, t1)


def _to_local(w, fx, fy, fz):
    return torch.stack([(w * fx).sum(-1), (w * fy).sum(-1),
                        (w * fz).sum(-1)], -1)


def _to_world(w, fx, fy, fz):
    return w[..., 0:1] * fx + w[..., 1:2] * fy + w[..., 2:3] * fz


def _shading_frame(hs: Hit, d):
    """(is_hair, fx, fy, fz): the hair frame on hair hits, else a frame
    around the surface normal flipped to face the ray (double-sided
    shading; the surface BSDF expects wo.z > 0)."""
    is_hair = hs.mat == 0
    nrm = hs.normal * torch.where(
        ((hs.normal * d).sum(-1) > 0)[:, None], -1.0, 1.0)
    t1, t2 = _diffuse_frame(nrm)
    fx = torch.where(is_hair[:, None], hs.tangent, t1)
    fy = torch.where(is_hair[:, None], hs.frame_y, t2)
    fz = torch.where(is_hair[:, None], hs.frame_z, nrm)
    return is_hair, fx, fy, fz


def _surface_at(scene: Scene, hs: Hit):
    """The hit surfaces' materials with their textures applied."""
    sp = scene.surf_mat.gather(hs.mat_id)
    if scene.tex_meta.shape[0]:
        sp = apply_textures(scene.tex_data, scene.tex_meta, sp, hs.uv)
    return sp


def trace_eyelight(scene: Scene, o, d, chunk=2048):
    """Debug sampler: the first hit shaded by a headlight."""
    hs = intersect_scene(scene, o, d, chunk=chunk)
    sp = _surface_at(scene, hs)
    is_hair, fx, fy, fz = _shading_frame(hs, d)
    wo = _to_local(-d, fx, fy, fz)
    f_hair = th.hair_f(th.material_at(scene.hair, hs.hair_mid), hs.h, wo,
                       wo) * torch.abs(wo[:, 2:3])
    f_surf = ts.surface_f(sp, wo, wo) * torch.abs(wo[:, 2:3]) + sp.emission
    f = torch.where(is_hair[:, None], f_hair, f_surf) * math.pi
    return torch.where(hs.hit[:, None], f, scene.env.expand_as(f))


def _shade(scene: Scene, hs: Hit, o, d, ub, depth, path, perm, chunk,
           use_nee, use_env, use_area, edge_softness):
    """One bounce after its nearest search: environment and emission
    terms, next-event estimation with shadow rays, BSDF sampling and
    Russian roulette. path: (L, beta, alive, prev_pdf, prev_delta) of
    the rays o, d; ub: the bounce's uniforms. -> (path, o, d) of the
    next bounce."""
    L, beta, alive, prev_pdf, prev_delta = path
    n, dev = o.shape[0], o.device
    miss = alive & ~hs.hit
    L = L + torch.where(miss[:, None], beta * scene.env, 0.0)
    # camera rays and delta bounces take a MIS weight of 1
    first = prev_delta | (depth == 0)
    if use_env:
        # env-map radiance on a miss, weighted against the previous
        # bounce's env NEE
        w = torch.ones_like(prev_pdf)
        if use_nee:
            w = torch.where(first, 1.0,
                            _mis(prev_pdf, env_pdf(scene, d)))
        L = L + torch.where(miss[:, None],
                            beta * env_eval(scene, d) * w[:, None], 0.0)
    alive = alive & hs.hit
    is_hair, fx, fy, fz = _shading_frame(hs, d)
    if tracing.enabled():
        # the lanes shaded, and those whose BSDF reads the hair material
        tracing.add("shade.live", alive.sum())
        tracing.add("shade.hair", (alive & is_hair).sum())
    # soft silhouettes: pass_th lanes go on through the strand
    pass_th = torch.zeros_like(alive)
    if edge_softness:
        cov = alive & is_hair
        alpha = torch.where(cov, torch.clamp(
            (1.0 - torch.abs(hs.h)) / edge_softness, 0.0, 1.0), 1.0)
        a_det = alpha.detach()
        # clamped away from 0 and 1, the branch probability bounds the
        # weights and their derivatives (unbiased for any a_s)
        a_s = torch.where(a_det >= 1.0, 1.0, torch.clamp(a_det, 0.2, 0.8))
        pass_th = cov & (ub[:, 10] >= a_s)
        beta = beta * torch.where(
            pass_th, (1.0 - alpha) / torch.clamp(1.0 - a_s, min=1e-6),
            alpha / torch.clamp(a_s, min=1e-6))[:, None]
    sp = _surface_at(scene, hs)
    # emission of surface hits (area lights BSDF rays find), weighted
    # against the area-light NEE that could have reached the point
    w_em = torch.ones_like(prev_pdf)
    if use_area:
        pdf_l = _area_light_pdf_sa(scene, torch.clamp(hs.light_id, min=0),
                                   o, hs.position, hs.gnormal)
        w = torch.where(first, 1.0, _mis(prev_pdf, pdf_l))
        w_em = torch.where(hs.light_id >= 0, w, 1.0)
    L = L + torch.where((alive & ~is_hair)[:, None],
                        beta * sp.emission * w_em[:, None], 0.0)

    wo = _to_local(-d, fx, fy, fz)
    pos = hs.position
    ray_eps = torch.where(is_hair, 2.0 * hs.radius, 1e-4)
    # next-event estimation skips the lanes that pass through
    lit = alive & ~pass_th
    if tracing.enabled():
        # one shadow ray a light, the env map and the area lights
        n_sh = ((scene.n_lights if use_nee else 0)
                + int(use_env and use_nee) + int(use_area))
        tracing.add("rays.shadow_lanes", n * n_sh)
        tracing.add("rays.shadow_live", lit.sum() * n_sh)

    # every next-event direction first: each point light's, the env map's
    # sample, an area light's point
    n_pt = scene.n_lights if use_nee else 0
    lights = []
    for li in range(n_pt):
        to_l = scene.light_pos[li] - pos
        dist = _norm(to_l)
        lights.append((dist, to_l / torch.clamp(dist[:, None], min=1e-12)))
    nee_w = [wi_w for _, wi_w in lights]
    if use_env and use_nee:
        wi_e, pdf_e = env_sample(scene, ub[:, 6], ub[:, 7])
        nee_w.append(wi_e)
    if use_area:
        el = torch.clamp(
            torch.searchsorted(scene.al_cdf, ub[:, 5].contiguous()),
            max=scene.n_area_lights - 1)
        lpos, lnrm, luv = _area_light_point(scene, el, ub[:, 8],
                                            ub[:, 9])
        lpos = lpos.detach()
        to_l = lpos - pos
        dist_a = _norm(to_l)
        wi_a = to_l / torch.clamp(dist_a[:, None], min=1e-12)
        nee_w.append(wi_a)
    nee = [_to_local(wi_w, fx, fy, fz) for wi_w in nee_w]
    # the hair BSDF towards them and its sample: on gradient-free passes on
    # the card one hair_kernel launch, else the torch code (bit-equal)
    if _hair_kernel_route(wo):
        hf, hpdf, wi_h, f_h, pdf_h = th.hair_bounce_kernel(
            scene.hair, hs.hair_mid, hs.h, wo, nee, ub[:, :4])
        if tracing.enabled():
            tracing.add("shade.hair_kernel", (alive & is_hair).sum())
    else:
        hf, hpdf, wi_h, f_h, pdf_h = th.hair_bounce(
            th.material_at(scene.hair, hs.hair_mid), hs.h, wo, nee,
            ub[:, :4], n_f=n_pt)

    def bsdf(j):
        """(f |cos|, detached pdf of BSDF sampling) towards nee[j]."""
        wi = nee[j]
        cos = torch.abs(wi[:, 2:3])
        f = torch.where(is_hair[:, None], hf[j] * cos,
                        ts.surface_f(sp, wo, wi) * cos)
        pdf_b = torch.where(is_hair, hpdf[j].detach(),
                            ts.surface_pdf(sp, wo, wi).detach())
        return f, pdf_b

    # direct lighting: every point light, deterministic sum
    for li, (dist, wi_w) in enumerate(lights):
        sh_o = pos + wi_w * ray_eps[:, None]
        vis = ~occluded_scene(scene, sh_o, wi_w, dist - ray_eps,
                              chunk=chunk, perm=perm)
        wi = nee[li]
        f_hair = hf[li] * torch.abs(wi[:, 2:3])
        f_surf = ts.surface_f(sp, wo, wi) * torch.abs(wi[:, 2:3])
        f = torch.where(is_hair[:, None], f_hair, f_surf)
        contrib = beta * f * scene.light_intensity[li] / torch.clamp(
            dist[:, None] ** 2, min=1e-12)
        L = L + torch.where((lit & vis)[:, None], contrib, 0.0)

    # environment-map NEE, weighted against BSDF sampling
    if use_env and use_nee:
        le = env_eval(scene, wi_e)
        sh_o = pos + wi_e * ray_eps[:, None]
        vis = ~occluded_scene(scene, sh_o, wi_e,
                              torch.full((n,), INF, device=dev),
                              chunk=chunk, perm=perm)
        f, pdf_b = bsdf(n_pt)
        contrib = beta * f * le * (
            _mis(pdf_e, pdf_b) / torch.clamp(pdf_e, min=1e-12))[:, None]
        L = L + torch.where((lit & vis)[:, None], contrib, 0.0)

    # area-light NEE (emissive spheres, mesh triangles)
    if use_area:
        pdf_a = _area_light_pdf_sa(scene, el, pos, lpos, lnrm).detach()
        sh_o = pos + wi_a * ray_eps[:, None]
        vis = ~occluded_scene(scene, sh_o, wi_a, dist_a - 2.0 * ray_eps,
                              chunk=chunk, perm=perm)
        f, pdf_b = bsdf(len(nee) - 1)
        le = scene.al_emission[el]
        if scene.tex_meta.shape[0]:
            # NEE integrates the same textured emission BSDF hits see
            le = le * sample_bilinear(scene.tex_data, scene.tex_meta,
                                      scene.al_tex[el], luv[:, 0],
                                      luv[:, 1])
        ok = lit & vis & (pdf_a > 1e-12) & (dist_a > 4.0 * ray_eps)
        contrib = beta * f * le * (
            _mis(pdf_a, pdf_b) / torch.clamp(pdf_a, min=1e-12))[:, None]
        L = L + torch.where(ok[:, None], contrib, 0.0)

    # BSDF sampling: the direction and its pdf are detached, f
    # carries the gradient
    w_hair = f_h * torch.abs(wi_h[:, 2:3]) / torch.clamp(
        pdf_h[:, None], min=1e-12)
    w_hair = torch.where((pdf_h > 1e-12)[:, None], w_hair, 0.0)
    wi_s, w_surf, pdf_s, delta_s = ts.surface_sample(sp, wo, ub[:, :3])
    wi = torch.where(is_hair[:, None], wi_h, wi_s)
    # pass-through lanes keep their ray and MIS state; weight 1
    beta = beta * torch.where(pass_th[:, None], 1.0, torch.where(
        is_hair[:, None], w_hair, w_surf))
    prev_pdf = torch.where(pass_th, prev_pdf,
                           torch.where(is_hair, pdf_h, pdf_s))
    prev_delta = torch.where(pass_th, prev_delta, ~is_hair & delta_s)
    d = torch.where(pass_th[:, None], d,
                    safe_normalize(_to_world(wi, fx, fy, fz)))
    o = pos + d * ray_eps[:, None]
    alive = alive & (torch.abs(beta).amax(-1) > 0)
    if depth >= RR_START:   # Russian roulette
        p_cont = torch.clamp(beta.detach().amax(-1), 0.05, 1.0)
        alive = alive & ~(ub[:, 4] > p_cont)
        beta = beta / p_cont[:, None]
    return (L, beta, alive, prev_pdf, prev_delta), o, d


def trace(scene: Scene, o, d, uniforms, max_depth=4, chunk=2048,
          sampler="path", sort_rays=None, edge_softness=0.0,
          device=None):
    """Path-trace a ray batch.

    o, d: (N, 3); uniforms: (N, n_uniform_dims(max_depth)). -> L (N, 3).
    sampler: "path" (next-event estimation and BSDF sampling, combined
    by the power heuristic), "naive" (BSDF sampling only) or "eyelight"
    (debug: the first hit under a headlight).
    sort_rays: sort each bounce's search by Morton cell (see
    ``_ray_sort_perm``; the image is bit-identical either way). None =
    on for large batches over large segment sets.
    edge_softness: > 0 gives strands soft silhouettes, the boundary term
    of geometry gradients. A hair hit whose width offset |h| lies in the
    outer (1 - edge_softness, 1] band survives with probability alpha =
    (1 - |h|) / edge_softness, else the ray passes through unchanged. The
    branch is drawn (uniform 10 of the bounce) on the detached alpha
    clamped to [0.2, 0.8] (a_s) and weighted by alpha / a_s or
    (1 - alpha) / (1 - a_s), so the value matches the oracle sample for
    sample and d alpha carries the silhouette's motion. 0 keeps exact
    hard edges.
    With tracing on (``utils.trace``), each bounce adds its lanes and
    live lanes, for its nearest search (``rays.bounce_lanes``,
    ``rays.bounce_live``) and its shadow searches
    (``rays.shadow_lanes``, ``rays.shadow_live``), and the live lanes
    it shades (``shade.live``), of those the lanes on hair
    (``shade.hair``) and the hair lanes ``hair_kernel`` shaded
    (``shade.hair_kernel``, counted where it runs).
    """
    if sampler not in ("path", "naive", "eyelight"):
        raise ValueError(f"unknown sampler {sampler!r}")
    dev = resolve_device(device)
    scene = scene.to(dev)
    o, d, uniforms = o.to(dev), d.to(dev), uniforms.to(dev)
    n = o.shape[0]
    if sampler == "eyelight":
        if tracing.enabled():
            tracing.add("rays.bounce_lanes", n)
            tracing.add("rays.bounce_live", n)
        return trace_eyelight(scene, o, d, chunk=chunk)
    use_nee = sampler == "path"
    use_env = has_env(scene)
    use_area = use_nee and scene.n_area_lights > 0
    if sort_rays is None:
        sort_rays = (max_depth > 1 and n >= 4096
                     and scene.segments.p0.shape[0] >= 4096)
    if sort_rays:
        sort_lo, sort_inv = _sort_bounds(scene)

    # radiance, throughput, alive, and the previous bounce's BSDF-sample
    # pdf and delta flag (MIS state)
    path = (torch.zeros_like(o), torch.ones_like(o),
            torch.ones((n,), dtype=torch.bool, device=dev), o.new_zeros((n,)),
            torch.zeros((n,), dtype=torch.bool, device=dev))
    perm = None
    for depth in range(max_depth):
        with tracing.span("yhair.bounce"):
            ub = uniforms[:, D_PIXEL + D_BOUNCE * depth:
                          D_PIXEL + D_BOUNCE * (depth + 1)]
            alive = path[2]
            if tracing.enabled():
                tracing.add("rays.bounce_lanes", n)
                tracing.add("rays.bounce_live", alive.sum())
            # dead lanes become far-away rays: their sorted blocks list no
            # clusters, so the kernels skip them
            o_int = torch.where(alive[:, None], o, 1e8)
            hs = intersect_scene(scene, o_int, d, chunk=chunk, perm=perm)
            with tracing.span("yhair.shading"):
                path, o, d = _shade(scene, hs, o, d, ub, depth, path, perm,
                                    chunk, use_nee, use_env, use_area,
                                    edge_softness)
            if sort_rays and depth + 1 < max_depth:
                with tracing.span("yhair.sort"):
                    perm = _ray_sort_perm(o.detach(), d.detach(), path[2],
                                          sort_lo, sort_inv)
    return path[0]


def render(scene: Scene, cam: Camera, uniforms, max_depth=4, chunk=2048,
           sampler="path", edge_softness=0.0, device=None):
    """Render from a full uniforms tensor (H, W, spp, D) -> (H, W, 3)."""
    dev = resolve_device(device)
    uniforms, cam = uniforms.to(dev), cam.to(dev)
    hgt, wid, spp, _ = uniforms.shape
    jj, ii = torch.meshgrid(torch.arange(hgt, device=dev),
                            torch.arange(wid, device=dev), indexing="ij")
    i = ii.reshape(-1).repeat_interleave(spp)
    j = jj.reshape(-1).repeat_interleave(spp)
    u = uniforms.reshape(hgt * wid * spp, -1)
    o, d = camera_rays(cam, wid, hgt, i.to(u.dtype), j.to(u.dtype),
                       u[:, :4])
    L = trace(scene, o, d, u, max_depth=max_depth, chunk=chunk,
              sampler=sampler, edge_softness=edge_softness, device=dev)
    return L.reshape(hgt, wid, spp, 3).mean(2)
