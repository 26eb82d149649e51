"""The triangle search (``geometry/triangles.search`` and ``occluded``) on
the CPU, against a NumPy brute force.

On the CPU the wrappers run the plain twin ``_search``; on a card they
launch ``tri_hit_kernel`` and ``tri_any_kernel``, which
``test_torch_kernels_cuda.py`` holds bit-equal to the twin there. The
brute force pins down the contract both are held to: Moller-Trumbore in
float32 with the twin's operations in the twin's order (ATen's cross
product, fused into one multiply-add where this CPU's build fuses it;
three-term sums left to right on the CPU), one IEEE reciprocal, the
strict bounds t_min < t < t_max, and the first triangle of least t, or
(INF, 0) where nothing is hit. ``occluded`` is that least t (over
(t_min, INF)) below dist * (1 - 1e-4).
"""

import functools

import numpy as np
import pytest
import torch

from yhair_tpu_torch.geometry import triangles as tri
from yhair_tpu_torch.utils import trace

F32, F64 = np.float32, np.float64
INF = F32(tri.INF)


def _fma32(a, b, c):
    """float32 a * b + c rounded once, exactly: the product is exact in
    float64, TwoSum gives the sum's rounding error, and a float64 sum
    that lands halfway between two float32 is settled by its sign."""
    p = a.astype(F64) * b.astype(F64)
    c = c.astype(F64)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    r = s.astype(F32)
    hi, lo = np.nextafter(r, F32(np.inf)), np.nextafter(r, F32(-np.inf))
    r64 = r.astype(F64)
    r = np.where((s == (r64 + hi.astype(F64)) / 2) & (err > 0), hi, r)
    return np.where((s == (r64 + lo.astype(F64)) / 2) & (err < 0), lo, r)


def _cross(a, b, fused):
    out = []
    for j, k in ((1, 2), (2, 0), (0, 1)):
        if fused:
            out.append(_fma32(a[..., j], b[..., k], -(a[..., k] * b[..., j])))
        else:
            out.append(a[..., j] * b[..., k] - a[..., k] * b[..., j])
    return np.stack(out, -1)


@functools.cache
def _cross_is_fused():
    """Whether this CPU's ATen fuses the cross product's products (its
    vectorized builds do); the brute force repeats whichever it does."""
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(4096, 3)).astype(F32) for _ in range(2))
    got = torch.linalg.cross(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    for fused in (True, False):
        if np.array_equal(got, _cross(a, b, fused)):
            return fused
    raise AssertionError("torch.linalg.cross matches neither form")


def _dot(a, b):
    """(a * b).sum(-1) over 3 as the CPU sums it: left to right."""
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2])


def _search_numpy(o, d, v0, v1, v2, t_min, t_max):
    """-> (t, idx int64): the twin's search, ray by ray in NumPy."""
    fused = _cross_is_fused()
    n, t_out, i_out = o.shape[0], [], []
    e1, e2 = v1 - v0, v2 - v0
    with np.errstate(all="ignore"):
        for r in range(n):
            pv = _cross(np.broadcast_to(d[r], e2.shape), e2, fused)
            det = _dot(e1, pv)
            inv = F32(1.0) / np.where(np.abs(det) < F32(1e-12), F32(1e-12),
                                      det)
            tv = o[r] - v0
            u = _dot(tv, pv) * inv
            qv = _cross(tv, e1, fused)
            v = _dot(np.broadcast_to(d[r], qv.shape), qv) * inv
            t = _dot(e2, qv) * inv
            ok = ((np.abs(det) > F32(1e-12)) & (u >= 0) & (v >= 0)
                  & (u + v <= 1) & (t > F32(t_min)) & (t < F32(t_max)))
            t = np.where(ok, t, INF)
            i = int(np.argmin(t)) if t.size else 0
            t_out.append(t[i] if t.size else INF)
            i_out.append(i)
    return np.asarray(t_out, F32), np.asarray(i_out, np.int64)


def _soup(n_tri, rng):
    """Random triangles around the origin (edges 0.05-0.6)."""
    v0 = rng.normal(size=(n_tri, 3)) * 1.0
    v1 = v0 + rng.normal(size=(n_tri, 3)) * 0.3
    v2 = v0 + rng.normal(size=(n_tri, 3)) * 0.3
    return [x.astype(F32) for x in (v0, v1, v2)]


def _aimed(n, rng, spread=1.0):
    """Rays from a shell at radius ~4 aimed near the origin."""
    o = rng.normal(size=(n, 3)) * 4.0
    d = rng.normal(size=(n, 3)) * spread - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(F32), d.astype(F32)


PLANE = 10.0  # where the plane triangles lie, away from the soups


def _plane_tiles():
    """Three overlapping right triangles in the plane z = 0.5 with
    power-of-two legs: every step of the test is exact for a ray along
    +z from z = 0, so it meets each of them at t = 0.5 exactly."""
    tiles = [((0.0, 0.0), 1.0), ((0.0, 0.0), 0.5), ((-0.25, -0.25), 2.0)]
    out = []
    for (x, y), leg in tiles:
        x, y = x + PLANE, y + PLANE
        out.append(((x, y, 0.5), (x + leg, y, 0.5), (x, y + leg, 0.5)))
    return np.asarray(out, F32)


def _straight_up(n, rng):
    """n rays along +z from z = 0 under all three plane triangles."""
    xy = PLANE + rng.uniform(0.01, 0.24, size=(n, 2))
    o = np.concatenate([xy, np.zeros((n, 1))], 1).astype(F32)
    return o, np.tile(np.asarray([[0.0, 0.0, 1.0]], F32), (n, 1))


def case_inputs(case):
    """-> dict(o, d, v0, v1, v2, dist, t_min, t_max, chunk) of one case,
    as NumPy float32 arrays, after checking that the case holds what it
    is named for (where the brute force can show it)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    t_min, t_max, chunk = 1e-4, tri.INF, 2048
    if case in ("t800", "n1", "n300"):
        n = {"t800": 1000, "n1": 1, "n300": 300}[case]
        v0, v1, v2 = _soup(800, rng)
        o, d = _aimed(n, rng)
    elif case == "t1":
        v0, v1, v2 = _soup(1, rng)
        o, d = _aimed(257, rng)
        d[::2] = (v0 + v1 + v2) / 3 - o[::2]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    elif case == "t5000":
        # several twin chunks (chunk 2,048) and kernel tiles
        v0, v1, v2 = _soup(5000, rng)
        o, d = _aimed(200, rng)
    elif case == "chunk7":
        v0, v1, v2 = _soup(300, rng)
        o, d = _aimed(300, rng)
        chunk = 7
    elif case == "empty":
        v0 = v1 = v2 = np.zeros((0, 3), F32)
        o, d = _aimed(130, rng)
    elif case == "ties":
        # triangle 3 moved out of the soup and duplicated at 400 and
        # 1,500, and three coplanar right triangles (at 11, 7 and 1,100)
        # that straight rays meet at t = 0.5 exactly: the lowest index
        # must win each tie
        v0, v1, v2 = _soup(2000, rng)
        away = np.asarray([-PLANE, 0.0, 0.0], F32)
        v0[3], v1[3], v2[3] = v0[3] + away, v1[3] + away, v2[3] + away
        for j in (400, 1500):
            v0[j], v1[j], v2[j] = v0[3], v1[3], v2[3]
        for j, tile in zip((11, 7, 1100), _plane_tiles()):
            v0[j], v1[j], v2[j] = tile
        o1, d1 = _aimed(200, rng)
        centre = (v0[3] + v1[3] + v2[3]) / 3
        o1[:100] = centre + rng.normal(size=(100, 3)) * 1.0
        d1[:100] = centre + rng.normal(size=(100, 3)) * 0.02 - o1[:100]
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        o2, d2 = _straight_up(56, rng)
        o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    elif case in ("t_min", "t_max", "ulp"):
        # rays along +z meet the plane triangles at t = 0.5 exactly: a
        # strict bound at 0.5 misses them, bounds one ulp off it do not
        v0, v1, v2 = (np.ascontiguousarray(x) for x in
                      np.moveaxis(_plane_tiles(), 1, 0))
        o, d = _straight_up(128, rng)
        if case == "t_min":
            t_min = 0.5
        elif case == "t_max":
            t_max = 0.5
        else:
            t_min = float(np.nextafter(F32(0.5), F32(0)))
            t_max = float(np.nextafter(F32(0.5), F32(1)))
    elif case == "degenerate":
        # every third triangle a point (det 0: never hit), every third a
        # segment (det at rounding level)
        v0, v1, v2 = _soup(600, rng)
        v1[::3], v2[::3] = v0[::3], v0[::3]
        v2[1::3] = v0[1::3] + 2 * (v1[1::3] - v0[1::3])
        o, d = _aimed(200, rng)
        d[:50] = (v0[:150:3] - o[:50])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    elif case == "dead":
        # lanes parked at 1e8 looking back along -(1, 1, 1), as the
        # integrator leaves them, beside live ones; one big triangle
        # across the diagonal catches them
        v0, v1, v2 = _soup(800, rng)
        v0[5], v1[5], v2[5] = (3.0, -3.0, 0.0), (-3.0, 0.0, 3.0), (0.0, 3.0,
                                                                 -3.0)
        o, d = _aimed(300, rng)
        o[::2] = 1e8
        d[::2] = -1.0 / np.sqrt(F32(3.0))
    else:
        raise ValueError(case)
    n = o.shape[0]
    dist = rng.uniform(0.5, 8.0, size=n).astype(F32)
    dist[::5] = INF  # env-map shadow rays
    inp = dict(o=np.ascontiguousarray(o, F32), d=np.ascontiguousarray(d, F32),
               v0=v0, v1=v1, v2=v2, dist=dist, t_min=t_min, t_max=t_max,
               chunk=chunk)
    _check_case(case, inp)
    return inp


def _check_case(case, inp):
    t, idx = _search_numpy(inp["o"], inp["d"], inp["v0"], inp["v1"],
                           inp["v2"], inp["t_min"], inp["t_max"])
    hit = t < INF
    assert (idx[~hit] == 0).all()
    if case == "empty":
        assert not hit.any()
    elif case == "ties":
        assert (idx[:100] == 3).sum() > 20
        assert (t[200:] == F32(0.5)).all() and (idx[200:] == 7).all()
    elif case in ("t_min", "t_max"):
        assert not hit.any()
    elif case == "ulp":
        assert (t == F32(0.5)).all() and (idx == 0).all()
    elif case == "degenerate":
        assert not (idx[hit] % 3 == 0).any()
    elif case == "dead":
        assert hit[::2].all()
    if case not in ("empty", "t_min", "t_max", "ulp"):
        assert hit.any() and (case == "n1" or not hit.all())


SEARCH_CASES = ("t800", "t1", "t5000", "chunk7", "n1", "n300", "empty",
                "ties", "t_min", "t_max", "ulp", "degenerate", "dead")


def torch_inputs(inp, device="cpu"):
    """-> (o, d, Triangles, dist) on a device."""
    def t(x):
        return torch.as_tensor(x, device=device)
    z = torch.zeros((inp["v0"].shape[0], 3), device=device)
    z2 = torch.zeros((inp["v0"].shape[0], 2), device=device)
    tris = tri.Triangles(t(inp["v0"]), t(inp["v1"]), t(inp["v2"]), z, z, z,
                         z2, z2, z2, torch.zeros(inp["v0"].shape[0],
                                                 dtype=torch.int32,
                                                 device=device))
    return t(inp["o"]), t(inp["d"]), tris, t(inp["dist"])


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_search_matches_numpy(case):
    """t and idx of the wrapper (the twin on the CPU) equal the brute
    force's bit for bit: random soups of 1, 800 and 5,000 triangles (one
    and several twin chunks and kernel tiles, a chunk of 7), 1 ray and
    counts that are no multiple of a block, no triangles, duplicated and
    coplanar ties, strict t_min and t_max at t, degenerate triangles, and
    lanes parked at 1e8."""
    inp = case_inputs(case)
    o, d, tris, _ = torch_inputs(inp)
    t, idx = tri.search(o, d, tris, inp["t_min"], inp["t_max"],
                        inp["chunk"])
    want_t, want_i = _search_numpy(inp["o"], inp["d"], inp["v0"], inp["v1"],
                                   inp["v2"], inp["t_min"], inp["t_max"])
    assert t.dtype == torch.float32 and idx.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), want_t)
    np.testing.assert_array_equal(idx.numpy(), want_i)


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_occluded_matches_numpy(case):
    """occluded equals the brute force's least t over (t_min, INF) below
    dist * (1 - 1e-4), with dist at INF on every fifth ray, as the
    env-map shadow rays pass it."""
    inp = case_inputs(case)
    o, d, tris, dist = torch_inputs(inp)
    got = tri.occluded(o, d, dist, tris, inp["t_min"], inp["chunk"])
    t, _ = _search_numpy(inp["o"], inp["d"], inp["v0"], inp["v1"],
                         inp["v2"], inp["t_min"], tri.INF)
    want = t < inp["dist"] * F32(1.0 - 1e-4)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_nearest_hit_recomputes_the_winner_for_gradients():
    """nearest_hit keeps the search's winners and recomputes t from the
    live triangle, so a gradient reaches the rays and the vertices."""
    inp = case_inputs("t800")
    o, d, tris, _ = torch_inputs(inp)
    v0 = tris.v0.clone().requires_grad_()
    o = o.clone().requires_grad_()
    t, idx, hit = tri.nearest_hit(o, d, tris._replace(v0=v0))
    want_t, want_i = tri.search(o.detach(), d, tris)
    assert torch.equal(idx, want_i) and torch.equal(hit, want_t < tri.INF)
    torch.where(hit, t, 0.0).sum().backward()
    assert o.grad.abs().sum() > 0 and v0.grad.abs().sum() > 0


def test_counters_count_the_rays_searched():
    inp = case_inputs("n300")
    o, d, tris, dist = torch_inputs(inp)
    trace.reset()
    trace.enable()
    try:
        tri.search(o, d, tris)
        tri.occluded(o, d, dist, tris)
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert counts["tri.rays"] == 600 and "tri.rays_kernel" not in counts


def _bad_inputs():
    inp = case_inputs("n300")
    o, d, tris, dist = torch_inputs(inp)
    wide = torch.cat([o, o], 1)
    return {
        "float64 rays": (o.double(), d.double(), tris, dist),
        "float64 dist": (o, d, tris, dist.double()),
        "float64 triangles": (o, d, tris._replace(v0=tris.v0.double()),
                              dist),
        "strided rays": (wide[:, ::2], d, tris, dist),
        "short dist": (o, d, tris, dist[:10]),
        "dist elsewhere": (o, d, tris, torch.empty(300, device="meta")),
    }


@pytest.mark.parametrize("what", ["float64 rays", "float64 dist",
                                  "float64 triangles", "strided rays",
                                  "short dist", "dist elsewhere"])
def test_wrappers_refuse_what_the_kernels_do_not_take(what):
    o, d, tris, dist = _bad_inputs()[what]
    with pytest.raises(ValueError):
        tri.occluded(o, d, dist, tris)
    if "dist" not in what:
        with pytest.raises(ValueError):
            tri.search(o, d, tris)
