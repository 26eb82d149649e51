"""Scene tensors for the forward hairball path (``yhair_tpu/core/scene.py``).

This slice carries what the curly hairball uses: hair segments with one
global hair material, the surface-material table, spheres, planes, point
lights, a constant environment, the per-segment material id and the
acceleration structure. ``from_dict`` refuses a scene with anything else
(triangle meshes, area lights, an environment map, textures, Bezier
curves, per-shape hair tables): those slices are not ported yet, and a
render without them would be a different image.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bsdf.hair import HairMaterial
from ..bsdf.surface import SurfaceMaterial
from ..device import resolve_device
from ..geometry.segments import Segments
from .camera import Camera


class Scene(NamedTuple):
    segments: Segments
    hair: HairMaterial         # one global material (0-dim / (3,) leaves)
    seg_mat_id: torch.Tensor   # (S,) int32 hair-material index per segment
    surf_mat: SurfaceMaterial  # (M, ...); sphere i -> i, plane j -> NS + j
    sph_center: torch.Tensor   # (NS, 3)
    sph_radius: torch.Tensor   # (NS,)
    pln_point: torch.Tensor    # (NP, 3)
    pln_normal: torch.Tensor   # (NP, 3)
    light_pos: torch.Tensor    # (L, 3)
    light_intensity: torch.Tensor  # (L, 3)
    env: torch.Tensor          # (3,) constant environment radiance
    accel: object = None       # ops.clusters.Clusters, or None -> brute force

    @property
    def n_spheres(self):
        return self.sph_center.shape[0]

    @property
    def n_planes(self):
        return self.pln_point.shape[0]

    @property
    def n_lights(self):
        return self.light_pos.shape[0]

    def to(self, device):
        """The scene with every tensor on ``device`` (no copy if there)."""
        fields = {}
        for name, v in self._asdict().items():
            fields[name] = None if v is None else v.to(device)
        return Scene(**fields)


def _material_from_legacy(prim: dict) -> dict:
    """The oracle's lowering: {'albedo': c} => matte (specular-free)."""
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
            "textured": any(int(m.get(k, -1)) >= 0 for k in (
                "color_tex", "emission_tex", "roughness_tex"))}


def _present(v) -> bool:
    return v is not None and (np.size(v) > 0 if isinstance(v, np.ndarray)
                              else bool(v))


def _refuse_unsupported(scene: dict, mats, n_spheres):
    found = [k for k in ("meshes", "env_map", "textures", "curves",
                         "hair_materials") if _present(scene.get(k))]
    if any((m["emission"] > 0).any() for m in mats[:n_spheres]):
        found.append("emissive spheres (area lights)")
    if any(m["textured"] for m in mats):
        found.append("textured materials")
    if found:
        raise NotImplementedError(
            "yhair_tpu_torch does not render these scene features yet: "
            + ", ".join(found))


def from_dict(scene: dict, device=None) -> Scene:
    """Oracle-format scene dict (``scenes.generators``) -> Scene on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    spheres = scene.get("spheres") or []
    planes = scene.get("planes") or []
    lights = scene.get("point_lights") or []
    mats = [_material_from_legacy(p) for p in list(spheres) + list(planes)]
    _refuse_unsupported(scene, mats, len(spheres))

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

    m = scene["hair_material"]
    hair = HairMaterial.make(
        sigma_a=np.asarray(m["sigma_a"]), beta_m=m["beta_m"],
        beta_n=m["beta_n"], alpha=m.get("alpha", np.deg2rad(2.0)),
        eta=m.get("eta", 1.55), device=dev)
    return Scene(
        segments=Segments(t(p0), t(p1), t(r0), t(r1)),
        hair=hair,
        seg_mat_id=torch.zeros((np.asarray(p0).shape[0],), dtype=torch.int32,
                               device=dev),
        surf_mat=SurfaceMaterial.make(mats, device=dev),
        sph_center=t([s["center"] for s in spheres], (0, 3)),
        sph_radius=t([s["radius"] for s in spheres], (0,)),
        pln_point=t([p["point"] for p in planes], (0, 3)),
        pln_normal=t([p["normal"] for p in planes], (0, 3)),
        light_pos=t([lt["position"] for lt in lights], (0, 3)),
        light_intensity=t([lt["intensity"] for lt in lights], (0, 3)),
        env=t(scene.get("environment", [0.0, 0.0, 0.0])),
    )


def camera_from_dict(cam: dict, device=None) -> Camera:
    return Camera.from_dict(cam, device=resolve_device(device))
