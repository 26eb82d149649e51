"""Scene files: a JSON description beside the PLY, .hair, OBJ and image
files it names (``yhair_tpu/io/scene_json.py``).

  {
    "camera":   {"position": [0,0.25,1.6], "look_at": [0,0,0],
                 "vfov_deg": 35, "aperture": 0.0, "focus_dist": 1.6},
    "hair_material": {"eumelanin": 1.3, "pheomelanin": 0.2,
                      "beta_m": 0.25, "beta_n": 0.3},
    "strands":  {"ply": "wig.ply"} | {"hair": "wStraight.hair"}
                | {"generator": "curly_hairball", "n_strands": 10000}
                | [{..., "material": {...}, "instances": [4x3 frames]}],
    "spheres":  [{"center": [0,0,0], "radius": 0.3, "albedo": [.3,.2,.1]}],
    "planes":   [...],
    "meshes":   [{"ply" | "obj": path} | {"generator": name, ...}
                 | {"positions", "triangles" | "quads", "normals"}],
    "point_lights": [{"position": [2,2,2], "intensity": [20,20,20]}],
    "environment": [0.05, 0.06, 0.08],
    "textures": [{"file": png|pfm|exr|hdr} | {"checker": {...}}
                 | {"gradient": {...}} | {"data": [[[r,g,b], ...]]}],
    "env_map":  (a texture entry),
    "curves":   {"cp": (C,4,3), "r0", "r1", "mat_id"} | [{"cp": 4x3, ...}]
  }

``load`` resolves a file to the scene and camera dicts that
``core.scene.from_dict`` and the oracle read; ``save`` writes a scene
dict back as such a file and its assets, byte for byte as the reference
writes them. The instance frames (``frame_matrix``,
``transform_segments``) bake posed strand shapes at load.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..geometry import shape_ops
from . import exr, hairfile, obj, ply
from . import image as img_io


def frame_matrix(frame):
    """yocto-style frame, 4 rows [x axis, y axis, z axis, origin] ->
    (M (3, 3) with the axes as columns, o (3,), s the uniform scale);
    points map as p' = M @ p + o. A non-uniform scale is refused: capsule
    radii would depend on direction."""
    f = np.asarray(frame, np.float64)
    if f.shape != (4, 3):
        raise ValueError(f"frame must be 4x3, got {f.shape}")
    M = np.stack([f[0], f[1], f[2]], axis=1)
    lens = np.linalg.norm(f[:3], axis=1)
    s = float(lens[0])
    if not np.allclose(lens, s, rtol=1e-4):
        raise ValueError(f"non-uniform instance scale {lens}")
    return M, f[3], s


def transform_segments(segs, frame):
    """Bake one instance: segments (p0, p1, r0, r1) posed by a frame."""
    M, o, s = frame_matrix(frame)
    p0, p1, r0, r1 = segs
    return (np.asarray(p0) @ M.T + o, np.asarray(p1) @ M.T + o,
            np.asarray(r0) * s, np.asarray(r1) * s)


def _resolve_material(m):
    from oracle.hair_bsdf import (sigma_a_from_concentration,
                                  sigma_a_from_reflectance)
    out = {
        "beta_m": float(m.get("beta_m", 0.3)),
        "beta_n": float(m.get("beta_n", 0.3)),
        "alpha": float(np.deg2rad(m.get("alpha_deg", 2.0))),
        "eta": float(m.get("eta", 1.55)),
    }
    if "sigma_a" in m:
        out["sigma_a"] = np.asarray(m["sigma_a"], np.float64)
    elif "eumelanin" in m or "pheomelanin" in m:
        out["sigma_a"] = sigma_a_from_concentration(
            float(m.get("eumelanin", 0.0)), float(m.get("pheomelanin", 0.0)))
    elif "color" in m:
        out["sigma_a"] = sigma_a_from_reflectance(
            np.asarray(m["color"], np.float64), out["beta_n"])
    else:
        out["sigma_a"] = np.array([0.06, 0.1, 0.2])
    return out


def _resolve_strands(spec, base_dir):
    if "ply" in spec:
        pos, rad, lines = ply.load_strands(os.path.join(base_dir, spec["ply"]))
        segs = ply.lines_to_segments(pos, rad, lines)
    elif "hair" in spec:
        h = hairfile.load(os.path.join(base_dir, spec["hair"]))
        segs = hairfile.to_segments(h, spec.get("radius_scale", 1.0))
    elif "generator" in spec:
        import scenes.generators as gen
        fn = getattr(gen, spec["generator"])
        kwargs = {k: v for k, v in spec.items()
                  if k not in ("generator", "material", "scale", "offset")}
        scene_d, _cam = fn(**kwargs)
        segs = scene_d["segments"]
    else:
        raise ValueError(f"unknown strand source {spec}")
    p0, p1, r0, r1 = segs
    scale = spec.get("scale", 1.0)
    offset = np.asarray(spec.get("offset", [0.0, 0.0, 0.0]), np.float64)
    return (p0 * scale + offset, p1 * scale + offset,
            np.asarray(r0, np.float64) * scale,
            np.asarray(r1, np.float64) * scale)


def _resolve_mesh(spec, base_dir):
    """Mesh entry: {'ply': path} | {'obj': path} | {'generator': name,
    ...kwargs} | inline {'positions': ..., 'triangles': ...,
    'normals': ...}; plus optional 'material', 'scale', 'offset'."""
    if "ply" in spec:
        mesh = ply.load_mesh(os.path.join(base_dir, spec["ply"]))
    elif "obj" in spec:
        mesh = obj.load_mesh(os.path.join(base_dir, spec["obj"]))
    elif "generator" in spec:
        import scenes.generators as gen
        fn = getattr(gen, spec["generator"])
        kwargs = {k: v for k, v in spec.items()
                  if k not in ("generator", "material", "scale", "offset")}
        mesh = fn(**kwargs)
    elif "positions" in spec:
        mesh = {"positions": np.asarray(spec["positions"], np.float64),
                "triangles": np.asarray(spec.get("triangles",
                                                 np.zeros((0, 3))),
                                        np.int64),
                "normals": (np.asarray(spec["normals"], np.float64)
                            if spec.get("normals") is not None else None)}
        if spec.get("quads") is not None:
            mesh["quads"] = np.asarray(spec["quads"], np.int64)
    else:
        raise ValueError(f"unknown mesh source {spec}")
    if mesh.get("quads") is not None and len(mesh.get("quads", ())):
        # quads are first-class in the scene format; triangulated here
        had_normals = mesh.get("normals") is not None
        mesh = shape_ops.quads_to_triangles(mesh)
        if not had_normals:
            mesh = shape_ops.compute_normals(mesh)
    if spec.get("subdivide"):
        mesh = shape_ops.subdivide_mesh(mesh, int(spec["subdivide"]))
    scale = spec.get("scale", 1.0)
    offset = np.asarray(spec.get("offset", [0.0, 0.0, 0.0]), np.float64)
    mesh = dict(mesh,
                positions=np.asarray(mesh["positions"],
                                     np.float64) * scale + offset)
    if "material" in spec:
        mesh["material"] = spec["material"]
    elif "albedo" in spec:
        mesh["albedo"] = spec["albedo"]
    return mesh


def _resolve_texture(spec, base_dir):
    """Texture entry: {'file': img.png|.pfm|.exr|.hdr} | {'checker':
    {...kwargs}} | {'gradient': {...kwargs}} | inline {'data':
    [[[r,g,b],...],...]}."""
    if "file" in spec:
        p = os.path.join(base_dir, spec["file"])
        if p.endswith(".pfm"):
            data = img_io.load_pfm(p)
        elif p.endswith(".exr"):
            data = exr.load_exr(p)
        elif p.endswith(".hdr"):
            data = img_io.load_radiance_hdr(p)
        else:
            data = img_io.load_png(p)
    elif "checker" in spec:
        from oracle.texture import checkerboard
        data = checkerboard(**spec["checker"])
    elif "gradient" in spec:
        from oracle.texture import uv_gradient
        data = uv_gradient(**spec["gradient"])
    elif "data" in spec:
        data = np.asarray(spec["data"], np.float64)
    else:
        raise ValueError(f"unknown texture source {spec}")
    return {"data": np.asarray(data, np.float64)}


def load(path):
    """-> (scene_dict, camera_dict) in the shared oracle format."""
    with open(path) as f:
        doc = json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    cam = doc.get("camera", {})
    camera = {
        "position": np.asarray(cam.get("position", [0, 0, 2]), np.float64),
        "look_at": np.asarray(cam.get("look_at", [0, 0, 0]), np.float64),
        "up": np.asarray(cam.get("up", [0, 1, 0]), np.float64),
        "vfov_deg": float(cam.get("vfov_deg", 35.0)),
    }
    for k in ("aperture", "focus_dist"):
        if k in cam:
            camera[k] = float(cam[k])
    strands = doc["strands"]
    if isinstance(strands, list):
        # multiple strand shapes, each with its own hair material ->
        # concatenated segment soup + per-segment material-table ids. A
        # shape entry may carry "instances": [4x3 frames], baked here so
        # every renderer reads the same flat geometry; the shared-tile
        # two-level path is accel-side (accel/instanced.py).
        parts = []
        mats = []
        for s in strands:
            shape = _resolve_strands(s, base)
            mat = _resolve_material(s.get("material",
                                          doc.get("hair_material", {})))
            for fr in s.get("instances", [None]):
                parts.append(shape if fr is None
                             else transform_segments(shape, fr))
                mats.append(mat)
        segs = tuple(np.concatenate([p[k] for p in parts])
                     for k in range(4))
        seg_mid = np.concatenate([np.full(len(p[0]), i, np.int64)
                                  for i, p in enumerate(parts)])
        extra = {"hair_materials": mats, "segment_mat_id": seg_mid}
    else:
        segs = _resolve_strands(strands, base)
        extra = {}
    scene = {
        "segments": segs,
        **extra,
        "hair_material": _resolve_material(doc.get("hair_material", {})),
        "spheres": doc.get("spheres", []),
        "planes": doc.get("planes", []),
        "meshes": [_resolve_mesh(m, base) for m in doc.get("meshes", [])],
        "point_lights": doc.get("point_lights", []),
        "environment": np.asarray(doc.get("environment", [0, 0, 0]),
                                  np.float64),
        "textures": [_resolve_texture(t, base)
                     for t in doc.get("textures", [])],
    }
    if "env_map" in doc:
        # environment map from any texture source (incl. {'file': x.hdr})
        scene["env_map"] = _resolve_texture(doc["env_map"], base)["data"]
    if "curves" in doc:
        scene["curves"] = _resolve_curves(doc["curves"])
    return scene, camera


def _resolve_curves(cv):
    """First-class cubic Bezier strands (core/scene._curve_arrays):
    either a LIST of {"cp": 4x3, "r0": r, "r1": r, "mat_id": i} entries
    or the array form {"cp": (C,4,3), "r0": (C,), "r1": (C,), ...}."""
    if isinstance(cv, list):
        out = {"cp": np.asarray([c["cp"] for c in cv], np.float64),
               "r0": np.asarray([c.get("r0", c.get("radius", 1e-3))
                                 for c in cv], np.float64),
               "r1": np.asarray([c.get("r1", c.get("radius", 1e-3))
                                 for c in cv], np.float64)}
        if any("mat_id" in c for c in cv):
            out["mat_id"] = np.asarray([c.get("mat_id", 0) for c in cv],
                                       np.int64)
        return out
    out = {"cp": np.asarray(cv["cp"], np.float64),
           "r0": np.asarray(cv["r0"], np.float64),
           "r1": np.asarray(cv["r1"], np.float64)}
    if cv.get("mat_id") is not None:
        out["mat_id"] = np.asarray(cv["mat_id"], np.int64)
    return out


def _material_json(m):
    return {
        "sigma_a": np.asarray(m["sigma_a"]).tolist(),
        "beta_m": float(m["beta_m"]), "beta_n": float(m["beta_n"]),
        "alpha_deg": float(np.rad2deg(m.get("alpha", 0.0349066))),
        "eta": float(m.get("eta", 1.55)),
    }


def save(path, scene, camera, strands_ply="strands.ply"):
    """Write the JSON + PLY(s) next to it holding the strand geometry.

    Multi-shape scenes ('hair_materials' + 'segment_mat_id') round-trip:
    one PLY per hair material is written and referenced from a 'strands'
    LIST, mirroring load()'s list form."""
    base = os.path.dirname(os.path.abspath(path))
    p0, p1, r0, r1 = (np.asarray(a) for a in scene["segments"])

    def write_strand_ply(name, sel):
        # rebuild a vertex/line representation from the segment soup
        v = np.concatenate([p0[sel], p1[sel]])
        r = np.concatenate([r0[sel], r1[sel]])
        n = int(sel.sum()) if sel.dtype == bool else len(sel)
        lines = np.stack([np.arange(n), np.arange(n) + n], axis=-1)
        ply.save_strands(os.path.join(base, name), v, r, lines)

    if scene.get("hair_materials"):
        mids = np.asarray(scene["segment_mat_id"])
        stem = os.path.splitext(strands_ply)[0]
        strands_doc = []
        for i, m in enumerate(scene["hair_materials"]):
            name = f"{stem}_{i}.ply"
            write_strand_ply(name, mids == i)
            strands_doc.append({"ply": name, "material": _material_json(m)})
    else:
        write_strand_ply(strands_ply, np.arange(len(p0)))
        strands_doc = {"ply": strands_ply}
    doc = {
        "camera": {k: (float(v) if np.ndim(v) == 0 else
                       np.asarray(v).tolist())
                   for k, v in camera.items()},
        "hair_material": _material_json(scene["hair_material"]),
        "strands": strands_doc,
        "spheres": scene.get("spheres", []),
        "planes": scene.get("planes", []),
        "meshes": [],
        "point_lights": scene.get("point_lights", []),
        "environment": np.asarray(scene.get("environment",
                                            [0, 0, 0])).tolist(),
    }

    for i, mesh in enumerate(scene.get("meshes") or []):
        mesh_ply = f"mesh_{i}.ply"
        ply.save_mesh(os.path.join(base, mesh_ply), mesh["positions"],
                      mesh["triangles"], mesh.get("normals"))
        entry = {"ply": mesh_ply}
        if "material" in mesh:
            entry["material"] = mesh["material"]
        elif "albedo" in mesh:
            entry["albedo"] = mesh["albedo"]
        doc["meshes"].append(entry)

    if scene.get("textures"):
        doc["textures"] = []
        for i, tex in enumerate(scene["textures"]):
            tex_pfm = f"texture_{i}.pfm"
            img_io.save_pfm(os.path.join(base, tex_pfm),
                            np.asarray(tex["data"], np.float64))
            doc["textures"].append({"file": tex_pfm})

    if scene.get("env_map") is not None:
        em = scene["env_map"]
        em = em.image if hasattr(em, "image") else em
        img_io.save_pfm(os.path.join(base, "env_map.pfm"),
                        np.asarray(em, np.float64))
        doc["env_map"] = {"file": "env_map.pfm"}

    if scene.get("curves"):
        cv = scene["curves"]
        doc["curves"] = {k: np.asarray(cv[k]).tolist()
                         for k in ("cp", "r0", "r1") if k in cv}
        if cv.get("mat_id") is not None:
            doc["curves"]["mat_id"] = np.asarray(cv["mat_id"]).tolist()

    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, (np.floating, np.integer)):
            return float(x)
        return x

    with open(path, "w") as f:
        json.dump(clean(doc), f, indent=1)
