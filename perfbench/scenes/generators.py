"""Frozen copies of the scene generators the benchmark's configurations
run: ``curly_hairball`` (config 3) and ``furry_bunny`` (config 5) of
``scenes/generators.py``, with the helpers of ``oracle/geometry.py`` and
``oracle/envmap.py`` they call. Copied so that a later change to those
files cannot move the benchmark's scenes; ``perfbench/tests`` hold the
copies equal to the originals. float64 numpy, as the originals.
"""

from __future__ import annotations

import numpy as np


def normalize(v, axis=-1):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-300)


def bezier_eval(cp, t):
    """Cubic Bezier point. cp: (..., 4, 3), t: (...,) -> (..., 3)."""
    t = np.asarray(t, dtype=np.float64)[..., None]
    u = 1.0 - t
    return (u ** 3 * cp[..., 0, :] + 3 * u ** 2 * t * cp[..., 1, :]
            + 3 * u * t ** 2 * cp[..., 2, :] + t ** 3 * cp[..., 3, :])


def bezier_to_segments(cp, radius0, radius1, n_seg=8):
    """Tessellate one cubic Bezier into `n_seg` line segments.

    Returns (p0, p1, r0, r1): (n_seg, 3) x2 and (n_seg,) x2, with radius
    lerped along the curve (strand taper).
    """
    cp = np.asarray(cp, dtype=np.float64)
    ts = np.linspace(0.0, 1.0, n_seg + 1)
    pts = bezier_eval(cp[None, :, :], ts)
    radii = radius0 + (radius1 - radius0) * ts
    return pts[:-1], pts[1:], radii[:-1], radii[1:]


def uv_to_direction(u, v):
    theta = v * np.pi
    phi = (u - 0.5) * 2.0 * np.pi
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), np.cos(theta), st * np.sin(phi)],
                    axis=-1)


def gradient_sky(h=64, w=128, horizon=(0.5, 0.55, 0.6), zenith=(0.2, 0.35,
                 0.7), sun_dir=(0.5, 0.6, 0.3), sun_power=200.0,
                 sun_radius=0.06, sun_color=(50.0, 45.0, 38.0)):
    """Procedural sky: vertical gradient + gaussian sun blob (no external
    HDRI assets are available offline)."""
    vs = (np.arange(h) + 0.5) / h
    us = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(us, vs)
    d = uv_to_direction(uu, vv)
    t = np.clip(d[..., 1], 0.0, 1.0)[..., None]
    img = (1 - t) * np.asarray(horizon) + t * np.asarray(zenith)
    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    cosang = np.clip((d * sd).sum(-1), -1, 1)
    blob = np.exp(-(np.arccos(cosang) / sun_radius) ** 2)
    img = img + blob[..., None] * np.asarray(sun_color)
    return img


def _strands_to_segments(ctrl_pts, radii_root, radii_tip, n_seg=8):
    """ctrl_pts: (N, 4, 3) cubic Bezier control points per strand."""
    p0s, p1s, r0s, r1s = [], [], [], []
    for k in range(ctrl_pts.shape[0]):
        p0, p1, r0, r1 = bezier_to_segments(ctrl_pts[k], radii_root[k],
                                            radii_tip[k], n_seg=n_seg)
        p0s.append(p0)
        p1s.append(p1)
        r0s.append(r0)
        r1s.append(r1)
    return (np.concatenate(p0s), np.concatenate(p1s),
            np.concatenate(r0s), np.concatenate(r1s))


DEFAULT_HAIR = {
    "sigma_a": np.array([0.06, 0.10, 0.20]),  # light brown
    "beta_m": 0.25,
    "beta_n": 0.3,
    "alpha": np.deg2rad(2.0),
    "eta": 1.55,
}


def icosphere(center=(0, 0, 0), radius=1.0, subdiv=2, stretch=(1, 1, 1)):
    """Triangle-mesh sphere by icosahedron subdivision.

    The mesh-shape analogue of the reference's shape ops (SURVEY.md §2.3
    [U:libs/yocto/yocto_shape.cpp] make_sphere/subdivide). Returns a mesh
    dict {positions, triangles, normals}; `stretch` makes ellipsoids
    (normals recomputed for the stretched surface).
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    v = normalize(v)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                  [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                  [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
                  [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        mid = {}
        verts = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                mid[key] = len(verts)
                verts.append(normalize(0.5 * (verts[a] + verts[b])))
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    s = np.asarray(stretch, np.float64)
    pos = v * s * radius + np.asarray(center, np.float64)
    # ellipsoid normal: gradient of the implicit surface = v / s
    nrm = normalize(v / s)
    return {"positions": pos, "triangles": f, "normals": nrm}


def mesh_area_cdf(mesh):
    """Per-triangle area CDF (the reference's `sample_shape` element CDF,
    SURVEY.md §2.3)."""
    pos = np.asarray(mesh["positions"], np.float64)
    tri = np.asarray(mesh["triangles"], np.int64)
    v = pos[tri]
    area = 0.5 * np.linalg.norm(
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
    cdf = np.cumsum(area)
    return cdf / cdf[-1], area


def fur_on_mesh(mesh, n_strands, length=(0.04, 0.08), curl=0.015,
                rng=None):
    """Grow fur strands from a triangle mesh: root points sampled
    area-uniformly over the surface, strands extruded along interpolated
    normals with a random lateral curl. Returns (N, 4, 3) Bezier control
    points — the data-prep analogue of the reference's hair-on-shape
    assets (SURVEY.md §3.5)."""
    rng = rng or np.random.default_rng(0)
    cdf, _ = mesh_area_cdf(mesh)
    pos = np.asarray(mesh["positions"], np.float64)
    tri = np.asarray(mesh["triangles"], np.int64)
    nrm = np.asarray(mesh["normals"], np.float64) \
        if mesh.get("normals") is not None else None
    ti = np.searchsorted(cdf, rng.random(n_strands))
    # uniform barycentric sample
    su = np.sqrt(rng.random(n_strands))
    bv = rng.random(n_strands)
    w0, w1, w2 = 1.0 - su, su * (1.0 - bv), su * bv
    v = pos[tri[ti]]
    roots = (w0[:, None] * v[:, 0] + w1[:, None] * v[:, 1]
             + w2[:, None] * v[:, 2])
    if nrm is not None:
        vn = nrm[tri[ti]]
        dirs = normalize(w0[:, None] * vn[:, 0] + w1[:, None] * vn[:, 1]
                         + w2[:, None] * vn[:, 2])
    else:
        dirs = normalize(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
    ln = rng.uniform(length[0], length[1], n_strands)[:, None]
    t1 = normalize(np.cross(dirs, rng.normal(0, 1, (n_strands, 3))))
    a1 = rng.uniform(curl / 3, curl, n_strands)[:, None]
    return np.stack([
        roots,
        roots + dirs * ln * 0.4 + t1 * a1,
        roots + dirs * ln * 0.7 + t1 * a1,
        roots + dirs * ln + t1 * a1 * 2,
    ], axis=1)


def _camera(position, look_at, vfov=35.0):
    return {"position": np.asarray(position, np.float64),
            "look_at": np.asarray(look_at, np.float64),
            "up": np.array([0.0, 1.0, 0.0]), "vfov_deg": vfov}


def curly_hairball(n_strands=10000, n_seg=12, seed=11):
    """Config 3: curly strands growing radially from a sphere."""
    rng = np.random.default_rng(seed)
    # uniform directions on the sphere
    z = rng.uniform(-1, 1, n_strands)
    phi = rng.uniform(0, 2 * np.pi, n_strands)
    r = np.sqrt(np.maximum(0.0, 1 - z * z))
    dirs = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
    r_scalp = 0.3
    roots = dirs * r_scalp
    length = rng.uniform(0.25, 0.4, n_strands)[:, None]
    # curl: offset control points in a random tangential corkscrew
    t1 = normalize(np.cross(dirs, rng.normal(0, 1, (n_strands, 3))))
    t2 = np.cross(dirs, t1)
    a1 = rng.uniform(0.05, 0.12, n_strands)[:, None]
    a2 = rng.uniform(0.05, 0.12, n_strands)[:, None]
    cp = np.stack([
        roots,
        roots + dirs * length * 0.4 + t1 * a1,
        roots + dirs * length * 0.7 - t1 * a1 + t2 * a2,
        roots + dirs * length + t1 * a1 * 0.5 - t2 * a2,
    ], axis=1)
    segs = _strands_to_segments(cp, np.full(n_strands, 0.0025),
                                np.full(n_strands, 0.001), n_seg=n_seg)
    scene = {
        "segments": segs,
        "hair_material": dict(DEFAULT_HAIR, beta_m=0.3, beta_n=0.4),
        "spheres": [{"center": [0.0, 0.0, 0.0], "radius": r_scalp * 0.98,
                     "albedo": [0.25, 0.15, 0.1]}],
        "point_lights": [
            {"position": [2.0, 2.5, 2.0], "intensity": [30.0, 30.0, 30.0]},
            {"position": [-2.5, 1.0, -1.0], "intensity": [10.0, 11.0, 13.0]},
        ],
        "environment": np.array([0.1, 0.11, 0.13]),
    }
    return scene, _camera([0.0, 0.25, 1.6], [0.0, 0.0, 0.0])


def bunny_mesh(subdiv=2):
    """Procedural triangle-mesh bunny: ellipsoid body + head + two ears
    (the Stanford-bunny asset is unavailable offline; this stands in for
    config 5's mesh body)."""
    parts = [
        icosphere([0.0, -0.1, 0.0], 0.30, subdiv, stretch=(1.0, 0.9, 1.2)),
        icosphere([0.0, 0.30, 0.16], 0.18, subdiv,
                  stretch=(0.9, 1.0, 1.05)),
        icosphere([-0.08, 0.52, 0.10], 0.055, max(subdiv - 1, 1),
                  stretch=(0.55, 2.2, 0.8)),
        icosphere([0.08, 0.52, 0.10], 0.055, max(subdiv - 1, 1),
                  stretch=(0.55, 2.2, 0.8)),
    ]
    off = 0
    pos, tris, nrm = [], [], []
    for p in parts:
        pos.append(p["positions"])
        tris.append(p["triangles"] + off)
        nrm.append(p["normals"])
        off += len(p["positions"])
    return {"positions": np.concatenate(pos),
            "triangles": np.concatenate(tris),
            "normals": np.concatenate(nrm),
            "material": {"color": [0.3, 0.25, 0.2], "roughness": 0.8,
                         "specular": 0.0}}


def furry_bunny(n_strands=50000, n_seg=6, seed=17, subdiv=2):
    """Config 5: fur grown on a triangle-mesh bunny (area-uniform roots,
    strands along surface normals), env-light dominated — the
    inverse-rendering target scene."""
    rng = np.random.default_rng(seed)
    body = bunny_mesh(subdiv=subdiv)
    cp = fur_on_mesh(body, n_strands, length=(0.04, 0.08), curl=0.015,
                     rng=rng)
    segs = _strands_to_segments(cp, np.full(n_strands, 0.0015),
                                np.full(n_strands, 0.0006), n_seg=n_seg)
    scene = {
        "segments": segs,
        "env_map": gradient_sky(),
        "hair_material": dict(DEFAULT_HAIR,
                              sigma_a=np.array([0.8, 1.2, 1.6]),
                              beta_m=0.4, beta_n=0.5),
        "meshes": [body],
        "planes": [{"point": [0.0, -0.45, 0.0], "normal": [0.0, 1.0, 0.0],
                    "albedo": [0.45, 0.45, 0.45]}],
        "point_lights": [
            {"position": [2.0, 2.0, 2.0], "intensity": [12.0, 12.0, 12.0]},
        ],
        "environment": np.array([0.35, 0.38, 0.42]),
    }
    return scene, _camera([0.0, 0.3, 1.5], [0.0, 0.05, 0.0])
