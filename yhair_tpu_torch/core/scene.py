"""Scene tensors (``yhair_tpu/core/scene.py``).

Hair segments with one global hair material or a per-shape table of
them (``hair_materials``, indexed by the per-segment material id), the
surface-material table (spheres, then planes, then meshes), spheres,
planes, triangle meshes, point lights, area lights (emissive spheres and
mesh triangles), a constant environment, an equirectangular environment
map with its sampling tables, textures, first-class cubic Bezier curves
and the acceleration structure (``Clusters``, ``InstancedClusters``,
``DeviceBVH`` or None for the brute-force scan).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bsdf.hair import HairMaterial
from ..bsdf.surface import SurfaceMaterial
from ..device import resolve_device
from ..geometry.segments import Segments
from ..geometry.triangles import Triangles
from . import envmap, texture
from .camera import Camera

LUM = np.array([0.2126, 0.7152, 0.0722])


class Scene(NamedTuple):
    segments: Segments
    hair: HairMaterial         # one global material (0-dim / (3,) leaves),
                               # or a table: (Mh,) / (Mh, 3) leaves
    seg_mat_id: torch.Tensor   # (S,) int32 hair-material index per segment
    surf_mat: SurfaceMaterial  # (M, ...); sphere i -> i, plane j -> NS + j,
                               # mesh k -> NS + NP + k
    sph_center: torch.Tensor   # (NS, 3)
    sph_radius: torch.Tensor   # (NS,)
    pln_point: torch.Tensor    # (NP, 3)
    pln_normal: torch.Tensor   # (NP, 3)
    tris: Triangles            # flattened triangle meshes (may be empty)
    light_pos: torch.Tensor    # (L, 3)
    light_intensity: torch.Tensor  # (L, 3)
    # area lights: the emissive elements (spheres, mesh triangles); empty
    # (0, ...) tables when there are none
    al_kind: torch.Tensor      # (A,) int32: 0 = triangle, 1 = sphere
    al_p0: torch.Tensor        # (A, 3) v0 / sphere center
    al_p1: torch.Tensor        # (A, 3) v1 / [radius, 0, 0]
    al_p2: torch.Tensor        # (A, 3) v2 / 0
    al_emission: torch.Tensor  # (A, 3)
    al_area: torch.Tensor      # (A,)
    al_pmf: torch.Tensor       # (A,)
    al_cdf: torch.Tensor       # (A,)
    al_uv0: torch.Tensor       # (A, 2) per-vertex texcoords (tri lights)
    al_uv1: torch.Tensor       # (A, 2)
    al_uv2: torch.Tensor       # (A, 2)
    al_tex: torch.Tensor       # (A,) int32 emission-texture id, -1 = none
    sph_light_id: torch.Tensor  # (NS,) int32 element id, -1 = not a light
    tri_light_id: torch.Tensor  # (T,) int32 aligned with tris
    env: torch.Tensor          # (3,) constant environment radiance
    env_map: torch.Tensor      # (H, W, 3) equirect map; (0, 0, 3) = none
    env_pmf: torch.Tensor      # (H*W,) texel pmf for importance sampling
    env_cdf: torch.Tensor      # (H*W,)
    env_sin: torch.Tensor      # (H,) sin(theta) per row
    tex_data: torch.Tensor     # (P, 3) flattened texel table (core/texture)
    tex_meta: torch.Tensor     # (T, 3) int32 (offset, H, W); (0, 3) = none
    # first-class cubic Bezier curves, intersected directly
    # (geometry/bezier.py), so gradients reach the control points
    crv_cp: torch.Tensor = None      # (C, 4, 3); (0, 4, 3) = none
    crv_r0: torch.Tensor = None      # (C,) root radius
    crv_r1: torch.Tensor = None      # (C,) tip radius
    crv_mat_id: torch.Tensor = None  # (C,) int32 hair-material table id
    accel: object = None       # Clusters, InstancedClusters, DeviceBVH,
                               # or None -> the brute-force scan

    @property
    def n_spheres(self):
        return self.sph_center.shape[0]

    @property
    def n_planes(self):
        return self.pln_point.shape[0]

    @property
    def n_lights(self):
        return self.light_pos.shape[0]

    @property
    def n_triangles(self):
        return self.tris.n_triangles

    @property
    def n_area_lights(self):
        return self.al_kind.shape[0]

    @property
    def n_curves(self):
        return 0 if self.crv_cp is None else self.crv_cp.shape[0]

    def to(self, device):
        """The scene with every tensor on ``device`` (no copy if there)."""
        return Scene(**{name: None if v is None else v.to(device)
                        for name, v in self._asdict().items()})

    def with_accel(self, accel, segments, seg_index):
        """The scene on ``seg_index``'s device, searched through ``accel``
        over its reordered ``segments`` of original ids ``seg_index``."""
        dev = seg_index.device
        sidx = seg_index.long()
        smid = self.seg_mat_id.to(dev)[torch.clamp(sidx, min=0)]
        smid = torch.where(sidx >= 0, smid, 0).to(torch.int32)
        return self.to(dev)._replace(segments=segments, accel=accel,
                                     seg_mat_id=smid)


def _material_from_legacy(prim: dict) -> dict:
    """The reference's lowering of a prim's material: {'albedo': c} =>
    matte (specular-free); texture ids default to -1."""
    m = dict(prim["material"]) if "material" in prim else {
        "color": prim.get("albedo", (0.0, 0.0, 0.0)), "specular": 0.0}
    return {"emission": np.asarray(m.get("emission", (0.0, 0.0, 0.0)),
                                   np.float64),
            "color": np.asarray(m.get("color", (0.0, 0.0, 0.0)), np.float64),
            "roughness": float(m.get("roughness", 1.0)),
            "metallic": float(m.get("metallic", 0.0)),
            "ior": float(m.get("ior", 1.5)),
            "transmission": float(m.get("transmission", 0.0)),
            "specular": float(m.get("specular", 1.0)),
            **{k: int(m.get(k, -1))
               for k in ("color_tex", "emission_tex", "roughness_tex")}}


def surface_materials(scene: dict) -> list:
    """One material per sphere, then per plane, then per mesh."""
    return [_material_from_legacy(p)
            for p in list(scene.get("spheres") or [])
            + list(scene.get("planes") or [])
            + list(scene.get("meshes") or [])]


def area_lights(scene: dict, mats: list):
    """The emissive-element light table, float64 numpy (the reference's
    ``oracle/pathtrace.py:scene_area_lights``): every emissive sphere
    (kind 1) and every triangle of an emissive mesh (kind 0), picked with
    pmf ~ area x emission luminance. None when nothing emits."""
    spheres = list(scene.get("spheres") or [])
    meshes = list(scene.get("meshes") or [])
    n_pl = len(scene.get("planes") or [])
    rows = {k: [] for k in ("kind", "p0", "p1", "p2", "emission", "area",
                            "uv0", "uv1", "uv2", "tex")}

    def add(**kw):
        for k, v in kw.items():
            rows[k].append(v)
    sph_light_id = np.full(len(spheres), -1, np.int64)
    tri_light_id = [np.zeros(0, np.int64)]
    for i, sph in enumerate(spheres):
        em = mats[i]["emission"]
        if (em > 0).any():
            sph_light_id[i] = len(rows["kind"])
            # a sphere's uv comes from the sampled normal at NEE time
            add(kind=1, p0=np.asarray(sph["center"], np.float64),
                p1=np.array([sph["radius"], 0.0, 0.0]), p2=np.zeros(3),
                emission=em, area=4.0 * np.pi * sph["radius"] ** 2,
                uv0=np.zeros(2), uv1=np.zeros(2), uv2=np.zeros(2),
                tex=mats[i]["emission_tex"])
    for mi, mesh in enumerate(meshes):
        mat = mats[len(spheres) + n_pl + mi]
        tri = np.asarray(mesh["triangles"], np.int64)
        ids = np.full(len(tri), -1, np.int64)
        if (mat["emission"] > 0).any():
            v = np.asarray(mesh["positions"], np.float64)[tri]
            tc = mesh.get("texcoords")
            uvv = (np.asarray(tc, np.float64)[tri] if tc is not None
                   else np.zeros((len(tri), 3, 2)))
            ar = 0.5 * np.linalg.norm(
                np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
            for ti in range(len(tri)):
                ids[ti] = len(rows["kind"])
                # the emission texture applies only where there are
                # texcoords
                add(kind=0, p0=v[ti, 0], p1=v[ti, 1], p2=v[ti, 2],
                    emission=mat["emission"], area=ar[ti], uv0=uvv[ti, 0],
                    uv1=uvv[ti, 1], uv2=uvv[ti, 2],
                    tex=mat["emission_tex"] if tc is not None else -1)
        tri_light_id.append(ids)
    if not rows["kind"]:
        return None
    al = {k: np.asarray(v) for k, v in rows.items()}
    power = al["area"] * np.maximum(al["emission"] @ LUM, 1e-12)
    al["pmf"] = power / power.sum()
    al["cdf"] = np.cumsum(al["pmf"])
    al["sph_light_id"] = sph_light_id
    al["tri_light_id"] = np.concatenate(tri_light_id)
    return al


def _hair(scene: dict, n_segments: int):
    """(HairMaterial leaves as float32 numpy, per-segment material id).
    ``hair_materials`` (a list of materials) with ``segment_mat_id`` make
    a table: the leaves get a leading (Mh,) dimension."""
    ms = scene.get("hair_materials")
    if not ms:
        m = scene["hair_material"]
        return (dict(sigma_a=m["sigma_a"], beta_m=m["beta_m"],
                     beta_n=m["beta_n"], alpha=m.get("alpha", np.deg2rad(2.0)),
                     eta=m.get("eta", 1.55)),
                np.zeros(n_segments, np.int32))
    if scene.get("segment_mat_id") is None:
        raise ValueError("hair_materials needs segment_mat_id")
    mid = np.asarray(scene["segment_mat_id"], np.int32)
    if mid.shape != (n_segments,):
        raise ValueError(f"segment_mat_id is {mid.shape}, expected "
                         f"({n_segments},)")
    return (dict(sigma_a=np.stack([np.asarray(m["sigma_a"]) for m in ms]),
                 beta_m=[m["beta_m"] for m in ms],
                 beta_n=[m["beta_n"] for m in ms],
                 alpha=[m.get("alpha", np.deg2rad(2.0)) for m in ms],
                 eta=[m.get("eta", 1.55) for m in ms]), mid)


def _curves(curves) -> dict:
    """scene["curves"] = {"cp": (C, 4, 3), "r0", "r1": (C,) or scalars,
    "mat_id": optional (C,) hair-material ids} -> float64/int32 numpy."""
    if not curves:
        return {"cp": np.zeros((0, 4, 3)), "r0": np.zeros(0),
                "r1": np.zeros(0), "mat_id": np.zeros(0, np.int32)}
    cp = np.asarray(curves["cp"], np.float64)
    if cp.ndim != 3 or cp.shape[1:] != (4, 3):
        raise ValueError(f"curve control points are {cp.shape}, expected "
                         f"(C, 4, 3)")
    c = cp.shape[0]
    mid = curves.get("mat_id")
    return {"cp": cp,
            "r0": np.broadcast_to(np.asarray(curves["r0"], np.float64), (c,)),
            "r1": np.broadcast_to(np.asarray(curves["r1"], np.float64), (c,)),
            "mat_id": (np.zeros(c, np.int32) if mid is None
                       else np.asarray(mid, np.int32))}


def from_dict(scene: dict, device=None) -> Scene:
    """Oracle-format scene dict (``scenes.generators``) -> Scene on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    spheres = scene.get("spheres") or []
    planes = scene.get("planes") or []
    meshes = scene.get("meshes") or []
    lights = scene.get("point_lights") or []

    if scene.get("segments") is not None and len(scene["segments"][0]):
        p0, p1, r0, r1 = scene["segments"]
    else:
        # prop-only scene: ONE far-away zero-radius segment, as the
        # reference does, so every gather stays in bounds
        p0 = np.full((1, 3), 1e8)
        p1 = p0 + np.array([[1.0, 0.0, 0.0]])
        r0 = r1 = np.zeros((1,))

    def t(x, shape=None):
        a = np.asarray(x, np.float64)
        if shape is not None and a.size == 0:
            a = np.zeros(shape)
        return torch.as_tensor(a.astype(np.float32), device=dev)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    mats = surface_materials(scene)
    tris = Triangles.from_meshes(meshes, mat_id0=len(spheres) + len(planes),
                                 device=dev)
    al = area_lights(scene, mats)
    if al is None:
        al = {k: np.zeros((0,) + s) for k, s in (
            ("kind", ()), ("p0", (3,)), ("p1", (3,)), ("p2", (3,)),
            ("emission", (3,)), ("area", ()), ("pmf", ()), ("cdf", ()),
            ("uv0", (2,)), ("uv1", (2,)), ("uv2", (2,)), ("tex", ()))}
        al["sph_light_id"] = np.full(len(spheres), -1)
        al["tri_light_id"] = np.full(tris.n_triangles, -1)
    env = scene.get("env_map")
    if env is not None:
        # an image, or an object that carries its own tables (EnvMap)
        env = ({k: getattr(env, k) for k in ("image", "pmf", "cdf", "sin_t")}
               if hasattr(env, "pmf") else envmap.env_tables(env))
    tex_data, tex_meta = texture.flatten_textures(
        [tx["data"] for tx in scene.get("textures") or []], device=dev)

    hair, seg_mat_id = _hair(scene, np.asarray(p0).shape[0])
    crv = _curves(scene.get("curves"))
    return Scene(
        segments=Segments(t(p0), t(p1), t(r0), t(r1)),
        hair=HairMaterial.make(**hair, device=dev),
        seg_mat_id=i32(seg_mat_id),
        surf_mat=SurfaceMaterial.make(mats, device=dev),
        sph_center=t([s["center"] for s in spheres], (0, 3)),
        sph_radius=t([s["radius"] for s in spheres], (0,)),
        pln_point=t([p["point"] for p in planes], (0, 3)),
        pln_normal=t([p["normal"] for p in planes], (0, 3)),
        tris=tris,
        light_pos=t([lt["position"] for lt in lights], (0, 3)),
        light_intensity=t([lt["intensity"] for lt in lights], (0, 3)),
        al_kind=i32(al["kind"]), al_p0=t(al["p0"]), al_p1=t(al["p1"]),
        al_p2=t(al["p2"]), al_emission=t(al["emission"]),
        al_area=t(al["area"]), al_pmf=t(al["pmf"]), al_cdf=t(al["cdf"]),
        al_uv0=t(al["uv0"]), al_uv1=t(al["uv1"]), al_uv2=t(al["uv2"]),
        al_tex=i32(al["tex"]), sph_light_id=i32(al["sph_light_id"]),
        tri_light_id=i32(al["tri_light_id"]),
        env=t(scene.get("environment", [0.0, 0.0, 0.0])),
        env_map=t(env["image"] if env else np.zeros((0, 0, 3))),
        env_pmf=t(env["pmf"] if env else np.zeros(0)),
        env_cdf=t(env["cdf"] if env else np.zeros(0)),
        env_sin=t(env["sin_t"] if env else np.zeros(0)),
        tex_data=tex_data, tex_meta=tex_meta,
        crv_cp=t(crv["cp"]), crv_r0=t(crv["r0"]), crv_r1=t(crv["r1"]),
        crv_mat_id=i32(crv["mat_id"]),
    )


def camera_from_dict(cam: dict, device=None) -> Camera:
    return Camera.from_dict(cam, device=resolve_device(device))
