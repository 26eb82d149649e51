"""Exact ray - segment searches of the plain reference, in plain torch.

Every (ray, group) pair whose box the ray enters is expanded into the
group's 128 capsule tests; nothing is pruned by a list or a prefix (the
nearest search's second pass, which picks the index, keeps the pairs a
ray enters by its least t). A hit is the closest approach of the ray's
line to the segment's axis within the interpolated radius at T_MIN < s
<= t_cap, in the arithmetic order of the capsule test the program states
(``yhair_tpu_torch/ops/intersect_kernel.py:_segment_test``), so equal
inputs give the same s. The nearest hit is the lexicographic minimum of
(s, original segment index).
"""

from __future__ import annotations

import torch

INF = 1e30
T_MIN = 1e-4
# pairs expanded at once: (PAIR_CHUNK, 128) temporaries
PAIR_CHUNK = 32768
RAY_CHUNK = 8192


def inverse_dir(d):
    small = torch.where(d < 0, -1e-12, 1e-12).to(d.dtype)
    return 1.0 / torch.where(torch.abs(d) < 1e-12, small, d)


def slab(o, inv, lo, hi):
    """(rays, boxes) entry distance tn (>= T_MIN) and whether the ray's
    slab interval is non-empty."""
    tn = torch.full((o.shape[0], lo.shape[0]), T_MIN, dtype=o.dtype,
                    device=o.device)
    tf = torch.full_like(tn, INF)
    for ax in range(3):
        t0 = (lo[None, :, ax] - o[:, ax, None]) * inv[:, ax, None]
        t1 = (hi[None, :, ax] - o[:, ax, None]) * inv[:, ax, None]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return tn, tn <= tf


def capsule_test(o, d, p0, d2, r0, dr, c_seg, t_cap):
    """o, d: (P, 1, 3); p0, d2: (P, K, 3); r0, dr, c_seg: (P, K);
    t_cap: (P, 1). -> (ok, s), each (P, K)."""
    oa = [o[..., ax] for ax in range(3)]
    da = [d[..., ax] for ax in range(3)]
    pa = [p0[..., ax] for ax in range(3)]
    qa = [d2[..., ax] for ax in range(3)]
    w0 = [oa[ax] - pa[ax] for ax in range(3)]
    b = da[0] * qa[0] + da[1] * qa[1] + da[2] * qa[2]
    dd = da[0] * w0[0] + da[1] * w0[1] + da[2] * w0[2]
    e = qa[0] * w0[0] + qa[1] * w0[1] + qa[2] * w0[2]
    denom = torch.clamp(c_seg - b * b, min=1e-12)
    u = torch.clamp((e - b * dd) / denom, 0.0, 1.0)
    s = b * u - dd
    off = [(oa[ax] + s * da[ax]) - (pa[ax] + u * qa[ax]) for ax in range(3)]
    dist2 = off[0] * off[0] + off[1] * off[1] + off[2] * off[2]
    r = r0 + dr * u
    ok = (dist2 <= r * r) & (s > T_MIN) & (s <= t_cap)
    return ok, s


def _pairs(o, inv, groups, t_max, lo):
    """Ray indices (offset by lo) and group indices of the pairs whose box
    the ray enters at tn <= t_max."""
    tn, hit = slab(o, inv, groups.lo, groups.hi)
    if t_max is not None:
        hit = hit & (tn <= t_max[:, None])
    r, c = hit.nonzero(as_tuple=True)
    return r + lo, c


def _expand(o, d, groups, r, c, t_cap):
    g = groups
    return capsule_test(o[r][:, None], d[r][:, None], g.p0[c], g.d2[c],
                        g.r0[c], g.dr[c], g.c[c], t_cap[:, None])


def nearest(o, d, groups):
    """-> (t (N,), original index (N,) int64, 0 on a miss, hit (N,)).
    The least t first, then the least index among the pairs at it."""
    n, dev = o.shape[0], o.device
    inv = inverse_dir(d)
    best_t = torch.full((n,), INF, dtype=o.dtype, device=dev)
    for lo in range(0, n, RAY_CHUNK):
        hi = min(lo + RAY_CHUNK, n)
        rr, cc = _pairs(o[lo:hi], inv[lo:hi], groups, None, lo)
        for a in range(0, rr.numel(), PAIR_CHUNK):
            r, c = rr[a:a + PAIR_CHUNK], cc[a:a + PAIR_CHUNK]
            cap = torch.full((r.numel(),), INF, dtype=o.dtype, device=dev)
            ok, s = _expand(o, d, groups, r, c, cap)
            best_t.scatter_reduce_(0, r, torch.where(ok, s, INF).amin(-1),
                                   "amin")
    hit = best_t < INF
    # the boxes a hit ray enters by its t hold every segment at that t
    t_max = torch.where(hit, best_t, -1.0)
    big = int(groups.oid.max()) + 1
    best_id = torch.full((n,), big, dtype=torch.int64, device=dev)
    for lo in range(0, n, RAY_CHUNK):
        hi = min(lo + RAY_CHUNK, n)
        rr, cc = _pairs(o[lo:hi], inv[lo:hi], groups, t_max[lo:hi], lo)
        for a in range(0, rr.numel(), PAIR_CHUNK):
            r, c = rr[a:a + PAIR_CHUNK], cc[a:a + PAIR_CHUNK]
            ok, s = _expand(o, d, groups, r, c, best_t[r])
            at = ok & (s == best_t[r][:, None])
            best_id.scatter_reduce_(
                0, r, torch.where(at, groups.oid[c], big).amin(-1), "amin")
    # in a precision below float32 a box can round past its own hit, and
    # the second pass then finds no index: such a ray counts as a miss
    hit = hit & (best_id < big)
    return best_t, torch.where(hit, best_id, 0), hit


def occluded(o, d, t_cap, groups):
    """True where some segment lies at T_MIN < s <= t_cap. (N,) bool."""
    n, dev = o.shape[0], o.device
    inv = inverse_dir(d)
    occ = torch.zeros((n,), dtype=torch.int32, device=dev)
    for lo in range(0, n, RAY_CHUNK):
        hi = min(lo + RAY_CHUNK, n)
        rr, cc = _pairs(o[lo:hi], inv[lo:hi], groups, t_cap[lo:hi], lo)
        for a in range(0, rr.numel(), PAIR_CHUNK):
            r, c = rr[a:a + PAIR_CHUNK], cc[a:a + PAIR_CHUNK]
            ok, _ = _expand(o, d, groups, r, c, t_cap[r])
            occ.scatter_reduce_(0, r, ok.any(-1).to(torch.int32), "amax")
    return occ > 0
