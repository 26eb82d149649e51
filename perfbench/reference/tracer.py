"""The plain reference's path tracer and what the cells compare with it.

Camera rays from the per-(pixel, sample, dimension) counter hash, then
a fixed number of bounces: the exact segment search of ``search.py``
(its winner recomputed from the live geometry, as the program states),
spheres, planes and brute-force triangles; next-event estimation
towards every point light and, with an environment map, one
environment sample weighted by the power heuristic; BSDF sampling with
detached directions and pdfs; Russian roulette from bounce 3. Rays are
never sorted: a ray's result does not depend on its batch.

``train_steps`` repeats an inverse-rendering run's first steps (loss,
gradients by autograd, Adam, the parameter bounds); ``render_pixels``
gives chosen pixels of a progressive render. Both take only the scene
dict, the benchmark's own inputs (seeds, tile draws, target) and a
dtype: float32 as the configurations state, or lower for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import bsdf, search
from .scene import RefScene, from_dict

INF = 1e30
RR_START = 3
D_PIXEL, D_BOUNCE = 4, 12
TILE_W, TILE_H = 16, 8
STRIP_RAYS = 65536
M32 = 0xFFFFFFFF
PARAM_BOUNDS = {"beta_m": (1e-3, 1.0), "beta_n": (1e-3, 1.0),
                "alpha": (0.0, 0.2), "sigma_a": (0.0, 20.0),
                "eta": (1.0, 2.0)}


# ---------------------------------------------------------------------------
# sample streams and camera


def seed_word(seed: int) -> int:
    return int(seed) & M32


def step_seed(seed: int, it: int) -> int:
    """Seed word of inverse step ``it`` of a run seeded with ``seed``."""
    return (seed_word(seed + 1) + 0x9E3779B1 * (it + 1)) & M32


def _mul32(a, m: int):
    lo = a & 0xFFFF
    hi = a >> 16
    return ((lo * m) + (((hi * m) & 0xFFFF) << 16)) & M32


def uniforms(word: int, pixel_ids, sample_ids, max_depth):
    """(N, 4 + 12 max_depth) float32 uniforms: a murmur3-style finalizer
    over (pixel, sample, dimension) plus the seed word, 24 bits kept."""
    nd = D_PIXEL + D_BOUNCE * max_depth
    pid = pixel_ids.to(torch.int64)[:, None]
    sid = sample_ids.to(torch.int64)[:, None]
    dim = torch.arange(nd, dtype=torch.int64, device=pid.device)[None, :]
    h = ((_mul32(pid, 0x9E3779B1) ^ _mul32(sid, 0x85EBCA77)
          ^ _mul32(dim, 0xC2B2AE3D)) + word) & M32
    for mult in (0x7FEB352D, 0x846CA68B):
        h = h ^ (h >> 16)
        h = _mul32(h, mult)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _normalize_rn(v):
    # the square root of the float32 sum correctly rounded
    n = torch.sqrt((v * v).sum(-1, keepdim=True).double()).to(v.dtype)
    return v / torch.clamp(n, min=1e-12)


def camera_rays(cam: dict, width, height, i, j, u_px, dtype):
    """Pinhole rays (the configurations have no aperture). Row 0 is the
    top of the image."""
    dev = i.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64).astype(np.float32),
                               device=dev).to(dtype)
    pos, look, up = t(cam["position"]), t(cam["look_at"]), t(
        cam.get("up", (0.0, 1.0, 0.0)))
    if float(cam.get("aperture", 0.0)) != 0.0:
        raise ValueError("the plain reference models pinhole cameras only")
    fwd = _normalize_rn(look - pos)
    right = _normalize_rn(bsdf.cross(fwd, up))
    upv = bsdf.cross(right, fwd)
    tan_half = torch.tan(t(cam["vfov_deg"]) * (math.pi / 180.0) * 0.5)
    aspect = width / height
    sx = (i + u_px[:, 0]) / width * 2.0 - 1.0
    sy = 1.0 - (j + u_px[:, 1]) / height * 2.0
    d = (fwd[None, :] + (sx * tan_half * aspect)[:, None] * right[None, :]
         + (sy * tan_half)[:, None] * upv[None, :])
    o = pos.expand(d.shape)
    # the thin lens at aperture 0 adds a zero offset
    r = t(0.0) * 0.5 * torch.sqrt(u_px[:, 2])
    theta = 2.0 * math.pi * u_px[:, 3]
    o = o + ((r * torch.cos(theta))[:, None] * right[None, :]
             + (r * torch.sin(theta))[:, None] * upv[None, :])
    return o, _normalize_rn(d)


# ---------------------------------------------------------------------------
# one bounce's geometry


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _closest_approach(o, d, p0, p1):
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
    return b * u - dd, u


def _sphere_t(sc, o, d):
    oc = o[:, None, :] - sc.sph_center[None]
    b = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - sc.sph_radius[None] ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    return torch.where((disc >= 0) & (t0 > 1e-4), t0,
                       torch.where((disc >= 0) & (t1 > 1e-4), t1, INF))


def _plane_t(sc, o, d):
    denom = (d[:, None, :] * sc.pln_normal[None]).sum(-1)
    tp = ((sc.pln_point[None] - o[:, None, :])
          * sc.pln_normal[None]).sum(-1) / torch.where(
        torch.abs(denom) < 1e-12, 1e-12, denom)
    return torch.where((torch.abs(denom) > 1e-9) & (tp > 1e-4), tp, INF)


def _mt(o, d, v0, v1, v2):
    e1 = v1 - v0
    e2 = v2 - v0
    pv = bsdf.cross(d, e2)
    det = (e1 * pv).sum(-1)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tv = o - v0
    u = (tv * pv).sum(-1) * inv
    qv = bsdf.cross(tv, e1)
    v = (d * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    return t, u, v, det


def _mt_hit(o, d, v0, v1, v2, t_min, t_max):
    t, u, v, det = _mt(o, d, v0, v1, v2)
    ok = ((torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t > t_min) & (t < t_max))
    return torch.where(ok, t, INF), u, v


@torch.no_grad()
def _tri_search(o, d, tri, t_min=1e-4, t_max=INF, ray_chunk=8192):
    """(least t or INF, first triangle at it) over every triangle."""
    ts, ids = [], []
    for lo in range(0, o.shape[0], ray_chunk):
        t, _, _ = _mt_hit(o[lo:lo + ray_chunk, None], d[lo:lo + ray_chunk,
                                                        None],
                          tri["v0"][None], tri["v1"][None], tri["v2"][None],
                          t_min, t_max)
        i = torch.argmin(t, -1)
        ts.append(t.gather(-1, i[:, None])[:, 0])
        ids.append(i)
    return torch.cat(ts), torch.cat(ids)


def _intersect(sc: RefScene, o, d):
    """Closest hit: t, mat (-1 miss, 0 hair, 1 surface), mat_id, position,
    normal, hair frame (tangent, y, z), h, radius."""
    n = o.shape[0]
    t_seg, oid, hit_seg = search.nearest(o.detach(), d.detach(), sc.groups)
    s_re, _ = _closest_approach(o, d, sc.p0[oid], sc.p1[oid])
    best_t = torch.where(hit_seg, s_re, INF)
    mat = torch.where(hit_seg, 0, -1).to(torch.int32)
    mat_id = torch.zeros((n,), dtype=torch.int64, device=o.device)
    normal = torch.zeros_like(o)
    if sc.sph_center.shape[0]:
        t_cand = _sphere_t(sc, o, d)
        i_s = torch.argmin(t_cand, -1)
        t_s = t_cand.gather(-1, i_s[:, None])[:, 0]
        closer = t_s < best_t
        best_t = torch.where(closer, t_s, best_t)
        mat = torch.where(closer, 1, mat)
        mat_id = torch.where(closer, i_s, mat_id)
        n_s = (o + t_s[:, None] * d) - sc.sph_center[i_s]
        n_s = n_s / torch.clamp(_norm(n_s)[:, None], min=1e-12)
        normal = torch.where(closer[:, None], n_s, normal)
    if sc.pln_point.shape[0]:
        tp = _plane_t(sc, o, d)
        i_p = torch.argmin(tp, -1)
        t_p = tp.gather(-1, i_p[:, None])[:, 0]
        closer = t_p < best_t
        best_t = torch.where(closer, t_p, best_t)
        mat = torch.where(closer, 1, mat)
        mat_id = torch.where(closer, sc.sph_center.shape[0] + i_p, mat_id)
        normal = torch.where(closer[:, None], sc.pln_normal[i_p], normal)
    if sc.tri["v0"].shape[0]:
        tr = sc.tri
        t_t, i_t = _tri_search(o.detach(), d.detach(), tr)
        hit_t = t_t < INF
        v0, v1, v2 = tr["v0"][i_t], tr["v1"][i_t], tr["v2"][i_t]
        t_re, _, _, _ = _mt(o, d, v0, v1, v2)
        t_t = torch.where(hit_t, t_re, INF)
        closer = torch.where(hit_t, t_t, INF) < best_t
        best_t = torch.where(closer, t_t, best_t)
        mat = torch.where(closer, 1, mat)
        _, u, v = _mt_hit(o, d, v0, v1, v2, -INF, INF)
        gn = bsdf.cross(v1 - v0, v2 - v0)
        gn = gn / torch.clamp(_norm(gn)[:, None], min=1e-20)
        w = 1.0 - u - v
        sn = (w[:, None] * tr["n0"][i_t] + u[:, None] * tr["n1"][i_t]
              + v[:, None] * tr["n2"][i_t])
        sn = sn / torch.clamp(_norm(sn)[:, None], min=1e-12)
        sn = sn * torch.where(((sn * gn).sum(-1) < 0)[:, None], -1.0,
                              1.0).to(sn.dtype)
        mat_id = torch.where(closer, tr["mat_id"][i_t], mat_id)
        normal = torch.where(closer[:, None], sn, normal)
    hit = best_t < INF
    is_hair = hit & (mat == 0)
    # the hair frame at the segment hit (computed on every lane)
    th = torch.where(is_hair, best_t, 0.0)
    p0, p1 = sc.p0[oid], sc.p1[oid]
    r0, r1 = sc.r0[oid], sc.r1[oid]
    _, u = _closest_approach(o, d, p0, p1)
    hit_pos = o + th[:, None] * d
    off = hit_pos - (p0 + u[:, None] * (p1 - p0))
    radius = r0 + (r1 - r0) * u
    tangent = bsdf.safe_normalize(p1 - p0)
    fz = bsdf.safe_normalize(
        -(d - (d * tangent).sum(-1, keepdim=True) * tangent))
    fy = bsdf.cross(fz, tangent)
    h = torch.clamp((off * fy).sum(-1) / torch.clamp(radius, min=1e-12),
                    -1.0, 1.0)
    pos = o + torch.where(hit, best_t, 0.0)[:, None] * d
    return {"hit": hit, "t": torch.where(hit, best_t, INF), "mat": mat,
            "mat_id": mat_id,
            "position": torch.where(is_hair[:, None], hit_pos, pos),
            "normal": normal, "tangent": tangent, "fy": fy, "fz": fz,
            "h": torch.where(is_hair, h, 0.0),
            "radius": torch.where(is_hair, radius, 0.0)}


def _occluded(sc: RefScene, o, d, dist):
    o, d, dist = o.detach(), d.detach(), dist.detach()
    limit = dist * (1.0 - 1e-4)
    occ = search.occluded(o, d, limit, sc.groups)
    if sc.sph_center.shape[0]:
        occ = occ | (_sphere_t(sc, o, d).amin(-1) < limit)
    if sc.pln_point.shape[0]:
        occ = occ | (_plane_t(sc, o, d).amin(-1) < limit)
    if sc.tri["v0"].shape[0]:
        t, _ = _tri_search(o, d, sc.tri)
        occ = occ | (t < limit)
    return occ


def _mis(a, b):
    return a ** 2 / torch.clamp(a ** 2 + b ** 2, min=1e-30)


def _to_local(w, fx, fy, fz):
    return torch.stack([(w * fx).sum(-1), (w * fy).sum(-1),
                        (w * fz).sum(-1)], -1)


def _to_world(w, fx, fy, fz):
    return w[..., 0:1] * fx + w[..., 1:2] * fy + w[..., 2:3] * fz


def _shading_frame(hs, d):
    is_hair = hs["mat"] == 0
    nrm = hs["normal"] * torch.where(
        ((hs["normal"] * d).sum(-1) > 0)[:, None], -1.0, 1.0).to(d.dtype)
    a = torch.where(torch.abs(nrm[:, 0:1]) > 0.9,
                    nrm.new_tensor([[0.0, 1.0, 0.0]]),
                    nrm.new_tensor([[1.0, 0.0, 0.0]]))
    t1 = bsdf.safe_normalize(bsdf.cross(nrm, a))
    t2 = bsdf.cross(nrm, t1)
    fx = torch.where(is_hair[:, None], hs["tangent"], t1)
    fy = torch.where(is_hair[:, None], hs["fy"], t2)
    fz = torch.where(is_hair[:, None], hs["fz"], nrm)
    return is_hair, fx, fy, fz


# ---------------------------------------------------------------------------
# the bounce loop


def trace(sc: RefScene, o, d, u, max_depth):
    """Radiance of each ray. o, d: (N, 3); u: (N, 4 + 12 max_depth)."""
    n, dev = o.shape[0], o.device
    use_env = sc.env_map.shape[0] > 0
    L = torch.zeros_like(o)
    beta = torch.ones_like(o)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = o.new_zeros((n,))
    prev_delta = torch.zeros((n,), dtype=torch.bool, device=dev)
    for depth in range(max_depth):
        ub = u[:, D_PIXEL + D_BOUNCE * depth:D_PIXEL + D_BOUNCE * (depth + 1)]
        # dead lanes trace from far away and find nothing
        hs = _intersect(sc, torch.where(alive[:, None], o, 1e8), d)
        miss = alive & ~hs["hit"]
        L = L + torch.where(miss[:, None], beta * sc.env, 0.0)
        first = prev_delta | (depth == 0)
        if use_env:
            w = torch.where(first, 1.0, _mis(prev_pdf, bsdf.env_pdf(sc, d)))
            L = L + torch.where(miss[:, None], beta * bsdf.env_eval(sc, d)
                                * w[:, None], 0.0)
        alive = alive & hs["hit"]
        is_hair, fx, fy, fz = _shading_frame(hs, d)
        sp = {k: v[hs["mat_id"]] for k, v in sc.surf.items()}
        wo = _to_local(-d, fx, fy, fz)
        pos = hs["position"]
        ray_eps = torch.where(is_hair, 2.0 * hs["radius"], 1e-4)
        hctx = bsdf.hair_ctx(sc.hair, hs["h"], wo)

        for li in range(sc.light_pos.shape[0]):
            to_l = sc.light_pos[li] - pos
            dist = _norm(to_l)
            wi_w = to_l / torch.clamp(dist[:, None], min=1e-12)
            vis = ~_occluded(sc, pos + wi_w * ray_eps[:, None], wi_w,
                             dist - ray_eps)
            wi = _to_local(wi_w, fx, fy, fz)
            f_hair = bsdf.hair_f(hctx, wi) * torch.abs(wi[:, 2:3])
            f_surf = bsdf.surface_f(sp, wo, wi) * torch.abs(wi[:, 2:3])
            f = torch.where(is_hair[:, None], f_hair, f_surf)
            contrib = beta * f * sc.light_intensity[li] / torch.clamp(
                dist[:, None] ** 2, min=1e-12)
            L = L + torch.where((alive & vis)[:, None], contrib, 0.0)

        if use_env:
            wi_w, pdf_e = bsdf.env_sample(sc, ub[:, 6], ub[:, 7])
            le = bsdf.env_eval(sc, wi_w)
            vis = ~_occluded(sc, pos + wi_w * ray_eps[:, None], wi_w,
                             torch.full((n,), INF, dtype=o.dtype,
                                        device=dev))
            wi = _to_local(wi_w, fx, fy, fz)
            fp_hair, pdf_hair = bsdf.hair_f_pdf(hctx, wi)
            cos = torch.abs(wi[:, 2:3])
            f = torch.where(is_hair[:, None], fp_hair * cos,
                            bsdf.surface_f(sp, wo, wi) * cos)
            pdf_b = torch.where(is_hair, pdf_hair.detach(),
                                bsdf.surface_pdf(sp, wo, wi).detach())
            contrib = beta * f * le * (
                _mis(pdf_e, pdf_b) / torch.clamp(pdf_e, min=1e-12))[:, None]
            L = L + torch.where((alive & vis)[:, None], contrib, 0.0)

        wi_h = bsdf.hair_sample_wi(hctx, ub[:, :4]).detach()
        f_h, pdf_h = bsdf.hair_f_pdf(hctx, wi_h)
        pdf_h = pdf_h.detach()
        w_hair = f_h * torch.abs(wi_h[:, 2:3]) / torch.clamp(
            pdf_h[:, None], min=1e-12)
        w_hair = torch.where((pdf_h > 1e-12)[:, None], w_hair, 0.0)
        wi_s, w_surf, pdf_s, delta_s = bsdf.surface_sample(sp, wo, ub[:, :3])
        wi = torch.where(is_hair[:, None], wi_h, wi_s)
        beta = beta * torch.where(is_hair[:, None], w_hair, w_surf)
        prev_pdf = torch.where(is_hair, pdf_h, pdf_s)
        prev_delta = ~is_hair & delta_s
        d = bsdf.safe_normalize(_to_world(wi, fx, fy, fz))
        o = pos + d * ray_eps[:, None]
        alive = alive & (torch.abs(beta).amax(-1) > 0)
        if depth >= RR_START:
            p_cont = torch.clamp(beta.detach().amax(-1), 0.05, 1.0)
            alive = alive & ~(ub[:, 4] > p_cont)
            beta = beta / p_cont[:, None]
    return L


# ---------------------------------------------------------------------------
# pixels, steps, images


def tile_order(width, height):
    """Pixel indices grouped into 16x8 screen tiles (row-major tiles,
    row-major pixels within a tile)."""
    pix = np.arange(width * height)
    x, y = pix % width, pix // width
    tile = (y // TILE_H) * (width // TILE_W) + (x // TILE_W)
    within = (y % TILE_H) * TILE_W + (x % TILE_W)
    return np.argsort(tile * (TILE_W * TILE_H) + within, kind="stable")


def pixel_samples(sc, cam, width, height, pixels, spp, word, max_depth,
                  dtype):
    """(P, spp, 3) radiance of every sample of the pixels."""
    pid = pixels.repeat_interleave(spp)
    sid = torch.arange(spp, device=pixels.device).repeat(pixels.shape[0])
    u = uniforms(word, pid, sid, max_depth).to(dtype)
    i = (pid % width).to(dtype)
    j = (pid // width).to(dtype)
    o, d = camera_rays(cam, width, height, i, j, u[:, :4], dtype)
    return trace(sc, o, d, u, max_depth).reshape(-1, spp, 3)


def draw_tiles(n_tiles, k, generator):
    return torch.randperm(n_tiles, generator=generator)[:k]


def train_steps(scene_d, cam, target, w, seed, n_steps, device, dtype,
                init):
    """The first n_steps of an inverse run, as the cell sets it up.

    w: the workload (width, height, spp, max_depth, pixel_batch, lr,
    params); init: {leaf: float32 array}, the starting values. ->
    {"loss": [...], "grad1": {leaf: tensor, the first gradient as Adam
    received it}, "params": [{leaf: tensor} after each step]}.
    """
    sc = from_dict(scene_d, device, dtype)
    width, height, spp = w["width"], w["height"], w["spp"]
    order = torch.as_tensor(tile_order(width, height), device=device)
    tile_px = TILE_W * TILE_H
    tgt = target.to(device=device, dtype=dtype).reshape(-1, 3)
    params = {k: torch.tensor(np.asarray(init[k], np.float32), device=device,
                              requires_grad=True) for k in w["params"]}
    opt = torch.optim.Adam(list(params.values()), lr=w["lr"])
    gen = torch.Generator().manual_seed(int(seed))
    out = {"loss": [], "grad1": None, "params": []}
    for it in range(n_steps):
        if w["pixel_batch"] is None:
            pixels = order
        else:
            tiles = draw_tiles(order.numel() // tile_px,
                               w["pixel_batch"] // tile_px, gen)
            pixels = order.reshape(-1, tile_px)[tiles.to(device)].reshape(-1)
        hair = dict(sc.hair, **{k: v.to(dtype) for k, v in params.items()})
        scp = sc._replace(hair=hair)
        n = pixels.numel() * 3
        for p in params.values():
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=device)
        px_strip = STRIP_RAYS // spp
        for a in range(0, pixels.numel(), px_strip):
            px = pixels[a:a + px_strip]
            img = pixel_samples(scp, cam, width, height, px, spp,
                                step_seed(seed, it), w["max_depth"],
                                dtype).mean(1)
            part = ((img - tgt[px]) ** 2).sum() / n
            part.backward()
            loss = loss + part.detach().float()
        for p in params.values():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = torch.where(torch.isfinite(g), g, 0.0)
        opt.step()
        with torch.no_grad():
            for k, p in params.items():
                p.clamp_(*PARAM_BOUNDS[k])
        if it == 0:
            out["grad1"] = {k: opt.state[p]["exp_avg"].detach().clone()
                            / (1.0 - opt.defaults["betas"][0])
                            if p in opt.state else torch.zeros_like(p)
                            for k, p in params.items()}
        out["loss"].append(float(loss))
        out["params"].append({k: v.detach().clone()
                              for k, v in params.items()})
    return out


def render_pixels(scene_d, cam, w, seed, pixels, device, dtype):
    """(P, 3) float64: the mean of samples [0, spp) of the pixels of an
    image rendered with seed ``seed``, summed in float64."""
    sc = from_dict(scene_d, device, dtype)
    word = seed_word(seed)
    out = []
    px_strip = STRIP_RAYS // w["spp"]
    with torch.no_grad():
        for a in range(0, pixels.numel(), px_strip):
            px = pixels[a:a + px_strip]
            L = pixel_samples(sc, cam, w["width"], w["height"], px,
                              w["spp"], word, w["max_depth"], dtype)
            out.append(L.double().sum(1) / w["spp"])
    return torch.cat(out)
