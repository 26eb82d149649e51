"""Frozen copy of ``scalp_model`` (config 4) of ``scenes/generators.py``,
with its own copy of the melanin map of ``oracle/hair_bsdf.py``; the
strand, camera and material helpers are those of the frozen
``generators.py`` beside it. ``perfbench/tests`` hold the copy equal to
the original. float64 numpy, as the original.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _frozen_generators():
    """The frozen ``generators.py`` of this directory, by its path (this
    file is itself loaded by path, so it has no package to import from)."""
    import importlib.util
    path = Path(__file__).with_name("generators.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_scene_generators_of_scalp", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_g = _frozen_generators()


def sigma_a_from_concentration(ce, cp):
    """Melanin concentrations -> absorption (eumelanin, pheomelanin)."""
    eumelanin = np.array([0.419, 0.697, 1.37])
    pheomelanin = np.array([0.187, 0.4, 1.05])
    ce = np.asarray(ce, dtype=np.float64)[..., None]
    cp = np.asarray(cp, dtype=np.float64)[..., None]
    return ce * eumelanin + cp * pheomelanin


def scalp_model(n_strands=30000, n_seg=10, seed=13, eumelanin=1.3,
                pheomelanin=0.2):
    """Config 4: head proxy (sphere) with strands on the upper hemisphere,
    melanin-parameterized color."""
    rng = np.random.default_rng(seed)
    # roots on upper hemisphere-ish cap
    z = rng.uniform(0.1, 1.0, n_strands)
    phi = rng.uniform(0, 2 * np.pi, n_strands)
    r = np.sqrt(np.maximum(0.0, 1 - z * z))
    dirs = np.stack([r * np.cos(phi), z, r * np.sin(phi)], axis=-1)
    r_head = 0.35
    roots = dirs * r_head
    g = np.array([0.0, -1.0, 0.0])  # gravity droop
    length = rng.uniform(0.3, 0.5, n_strands)[:, None]
    t1 = _g.normalize(np.cross(dirs, rng.normal(0, 1, (n_strands, 3))))
    a1 = rng.uniform(0.02, 0.06, n_strands)[:, None]
    cp = np.stack([
        roots,
        roots + dirs * length * 0.35 + t1 * a1,
        roots + dirs * length * 0.55 + g * length * 0.25 - t1 * a1,
        roots + dirs * length * 0.6 + g * length * 0.6,
    ], axis=1)
    segs = _g._strands_to_segments(cp, np.full(n_strands, 0.002),
                                   np.full(n_strands, 0.0008), n_seg=n_seg)
    scene = {
        "segments": segs,
        "hair_material": dict(
            _g.DEFAULT_HAIR,
            sigma_a=sigma_a_from_concentration(eumelanin, pheomelanin),
            beta_m=0.25, beta_n=0.35),
        "spheres": [{"center": [0.0, 0.0, 0.0], "radius": r_head * 0.99,
                     "albedo": [0.5, 0.35, 0.28]}],
        "point_lights": [
            {"position": [2.0, 3.0, 2.5], "intensity": [40.0, 40.0, 40.0]},
            {"position": [-2.0, 1.0, 2.0], "intensity": [15.0, 16.0, 18.0]},
        ],
        "environment": np.array([0.12, 0.13, 0.15]),
    }
    return scene, _g._camera([0.0, 0.35, 1.7], [0.0, 0.1, 0.0])
