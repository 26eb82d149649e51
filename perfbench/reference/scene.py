"""The plain reference's scene: tensors rebuilt from a configuration's
scene dict (the frozen generators' float64 arrays), never from anything
the program derived.

It models what the benchmark's configurations hold: hair segments with
one hair material, spheres, planes and triangle meshes with non-emissive
surface materials, point lights, a constant environment and an
equirectangular environment map. A scene with anything else (emissive
surfaces, textures, curves, per-shape hair tables) is refused, so a new
configuration cannot pass through a reference that ignores part of it.

Its own acceleration structure: segments in Morton order of their
midpoints, cut into groups of 128 with conservative boxes
(``search.py`` tests every segment of every box a ray enters).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GROUP = 128
# padding lanes: far away, zero radius, never hit
FAR = 1e8


class Groups(NamedTuple):
    """Segments in groups of GROUP, each array (G, GROUP[, 3])."""
    p0: torch.Tensor
    d2: torch.Tensor      # p1 - p0
    r0: torch.Tensor
    dr: torch.Tensor      # r1 - r0
    c: torch.Tensor       # |d2|^2, summed x, y, z in that order
    oid: torch.Tensor     # int64 original segment index; padding = S
    lo: torch.Tensor      # (G, 3) box
    hi: torch.Tensor


class RefScene(NamedTuple):
    p0: torch.Tensor          # (S, 3) original segment order
    p1: torch.Tensor
    r0: torch.Tensor          # (S,)
    r1: torch.Tensor
    hair: dict                # sigma_a (3,), beta_m, beta_n, alpha, eta ()
    surf: dict                # (M, ...) per surface material
    sph_center: torch.Tensor  # (NS, 3)
    sph_radius: torch.Tensor
    pln_point: torch.Tensor   # (NP, 3)
    pln_normal: torch.Tensor
    tri: dict                 # v0, v1, v2, n0, n1, n2 (T, 3); mat_id (T,)
    light_pos: torch.Tensor   # (L, 3)
    light_intensity: torch.Tensor
    env: torch.Tensor         # (3,)
    env_map: torch.Tensor     # (H, W, 3); (0, 0, 3) = none
    env_pmf: torch.Tensor
    env_cdf: torch.Tensor
    env_sin: torch.Tensor
    groups: Groups


def _refuse(scene: dict):
    for key in ("textures", "curves", "hair_materials", "instances"):
        if scene.get(key):
            raise ValueError(f"the plain reference does not model {key!r}")
    for prim in (list(scene.get("spheres") or [])
                 + list(scene.get("planes") or [])
                 + list(scene.get("meshes") or [])):
        mat = prim.get("material", {})
        if np.any(np.asarray(mat.get("emission", 0.0)) > 0):
            raise ValueError("the plain reference does not model "
                             "emissive surfaces")
        if any(int(mat.get(k, -1)) >= 0 for k in
               ("color_tex", "emission_tex", "roughness_tex")):
            raise ValueError("the plain reference does not model textures")


def _material(prim: dict) -> dict:
    """A prim's surface material; {'albedo': c} is a matte one."""
    m = dict(prim["material"]) if "material" in prim else {
        "color": prim.get("albedo", (0.0, 0.0, 0.0)), "specular": 0.0}
    return {"color": np.broadcast_to(np.asarray(
                m.get("color", (0.0, 0.0, 0.0)), np.float64), (3,)),
            "roughness": float(m.get("roughness", 1.0)),
            "metallic": float(m.get("metallic", 0.0)),
            "ior": float(m.get("ior", 1.5)),
            "transmission": float(m.get("transmission", 0.0)),
            "specular": float(m.get("specular", 1.0))}


def _env_tables(image):
    """pmf ~ luminance x sin(theta) per texel, its float64 cumulative
    sum, and sin(theta) per row."""
    image = np.asarray(image, np.float64)
    h = image.shape[0]
    sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
    weights = (image.mean(-1) * sin_t[:, None]).reshape(-1)
    if weights.sum() <= 0:
        weights = np.ones_like(weights)
    pmf = weights / weights.sum()
    return image, pmf, np.cumsum(pmf), sin_t


def _morton3(q):
    """Interleave three 10-bit integer coordinates (int64 tensors)."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build_groups(p0, p1, r0, r1) -> Groups:
    """Morton-ordered groups of GROUP segments with boxes that hold each
    capsule (its axis grown by the larger radius, then by a relative
    1e-6 so no rounding of the box can cut a hit off)."""
    s, dev, dt = p0.shape[0], p0.device, p0.dtype
    mid = (0.5 * (p0 + p1)).float()
    lo, hi = mid.amin(0), mid.amax(0)
    q = ((mid - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).long()
    order = torch.argsort(_morton3(torch.clamp(q, 0, 1023)), stable=True)
    g = -(-s // GROUP)
    pad = g * GROUP - s

    def grouped(x, fill):
        x = x[order]
        if pad:
            x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
        return x.reshape((g, GROUP) + x.shape[1:])
    a0, a1 = grouped(p0, FAR), grouped(p1, FAR)
    b0, b1 = grouped(r0, 0.0), grouped(r1, 0.0)
    oid = grouped(torch.arange(s, device=dev), s)
    d2 = a1 - a0
    c = d2[..., 0] * d2[..., 0] + d2[..., 1] * d2[..., 1] \
        + d2[..., 2] * d2[..., 2]
    real = (oid < s)[..., None]
    rad = torch.maximum(b0, b1)[..., None]
    big = torch.tensor(3e38, dtype=torch.float32, device=dev)
    lo_b = torch.where(real, torch.minimum(a0, a1).float() - rad.float(),
                       big).amin(1)
    hi_b = torch.where(real, torch.maximum(a0, a1).float() + rad.float(),
                       -big).amax(1)
    grow = 1e-6 * (hi_b - lo_b).abs() + 1e-6
    return Groups(a0, d2, b0, b1 - b0, c, oid, (lo_b - grow).to(dt),
                  (hi_b + grow).to(dt))


def from_dict(scene: dict, device, dtype=torch.float32) -> RefScene:
    """Scene dict -> RefScene on ``device``, its floats in ``dtype``
    (float32, or a lower precision for the control), each value first
    rounded to float32 as the configuration states."""
    _refuse(scene)
    spheres = list(scene.get("spheres") or [])
    planes = list(scene.get("planes") or [])
    meshes = list(scene.get("meshes") or [])
    lights = list(scene.get("point_lights") or [])

    def t(x, shape=None):
        a = np.asarray(x, np.float64)
        if shape is not None and a.size == 0:
            a = np.zeros(shape)
        return torch.as_tensor(a.astype(np.float32), device=device).to(dtype)

    p0, p1, r0, r1 = (t(a) for a in scene["segments"])
    hm = scene["hair_material"]
    hair = {"sigma_a": t(hm["sigma_a"]), "beta_m": t(hm["beta_m"]),
            "beta_n": t(hm["beta_n"]),
            "alpha": t(hm.get("alpha", np.deg2rad(2.0))),
            "eta": t(hm.get("eta", 1.55))}
    mats = [_material(p) for p in spheres + planes + meshes] or [
        _material({"albedo": (0.0, 0.0, 0.0)})]
    surf = {k: t([m[k] for m in mats]) for k in mats[0]}
    vs, ns, mids = [np.zeros((0, 3, 3))], [np.zeros((0, 3, 3))], [
        np.zeros(0, np.int64)]
    for i, mesh in enumerate(meshes):
        pos = np.asarray(mesh["positions"], np.float64)
        tri = np.asarray(mesh["triangles"], np.int64)
        v = pos[tri]
        if mesh.get("normals") is not None:
            vn = np.asarray(mesh["normals"], np.float64)[tri]
        else:
            gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
            gn = gn / np.maximum(np.linalg.norm(gn, axis=-1,
                                                keepdims=True), 1e-20)
            vn = np.broadcast_to(gn[:, None], v.shape)
        vs.append(v)
        ns.append(vn)
        mids.append(np.full(len(tri), len(spheres) + len(planes) + i))
    v, vn = np.concatenate(vs), np.concatenate(ns)
    tri = {f"v{k}": t(v[:, k]) for k in range(3)}
    tri.update({f"n{k}": t(vn[:, k]) for k in range(3)})
    tri["mat_id"] = torch.as_tensor(np.concatenate(mids), device=device)
    if scene.get("env_map") is not None:
        image, pmf, cdf, sin_t = _env_tables(scene["env_map"])
    else:
        image, pmf, cdf, sin_t = (np.zeros((0, 0, 3)), np.zeros(0),
                                  np.zeros(0), np.zeros(0))
    return RefScene(
        p0=p0, p1=p1, r0=r0, r1=r1, hair=hair, surf=surf,
        sph_center=t([s["center"] for s in spheres], (0, 3)),
        sph_radius=t([s["radius"] for s in spheres], (0,)),
        pln_point=t([p["point"] for p in planes], (0, 3)),
        pln_normal=t([p["normal"] for p in planes], (0, 3)),
        tri=tri,
        light_pos=t([lt["position"] for lt in lights], (0, 3)),
        light_intensity=t([lt["intensity"] for lt in lights], (0, 3)),
        env=t(scene.get("environment", [0.0, 0.0, 0.0])),
        env_map=t(image), env_pmf=t(pmf), env_cdf=t(cdf), env_sin=t(sin_t),
        groups=build_groups(p0, p1, r0, r1))
