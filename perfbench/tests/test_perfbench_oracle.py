"""The plain reference against the repository's float64 NumPy oracle
(``oracle/``, written apart from the port): the hair and surface BSDFs
and the environment map on random directions, the camera, and whole
paths of every configuration's tiny scene fed the same rays and
uniforms. The reference runs in float64 here, so any gap beyond
round-off is a difference of method, not of precision."""

import numpy as np
import pytest
import torch

from conftest import bench, tiny_scene

N = 4096


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - b).max()
                 / max(np.abs(b).max(), 1e-30))


def test_hair_bsdf_equals_the_oracle():
    from oracle.hair_bsdf import HairBSDF

    from perfbench.reference import bsdf
    rng = np.random.default_rng(0)
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    h = rng.uniform(-0.95, 0.95, N)
    mat = {"sigma_a": np.array([0.4, 0.8, 1.5]), "beta_m": 0.3,
           "beta_n": 0.4, "alpha": np.deg2rad(2.0), "eta": 1.55}
    ctx = bsdf.hair_ctx({k: _t(v) for k, v in mat.items()}, _t(h), _t(wo))
    f, pdf = bsdf.hair_f_pdf(ctx, _t(wi))
    ora = HairBSDF(h, mat["sigma_a"], mat["beta_m"], mat["beta_n"],
                   mat["alpha"], mat["eta"])
    assert _rel(f.numpy(), ora.f(wo, wi)) < 1e-12
    assert _rel(bsdf.hair_f(ctx, _t(wi)).numpy(), ora.f(wo, wi)) < 1e-12
    assert _rel(pdf.numpy(), ora.pdf(wo, wi)) < 1e-12


@pytest.mark.parametrize("material", [
    {"color": (0.6, 0.5, 0.4), "specular": 0.0},
    {"color": (0.8, 0.7, 0.2), "roughness": 0.3, "metallic": 1.0},
    {"color": (0.5, 0.5, 0.5), "roughness": 0.2, "specular": 1.0},
    {"color": (0.9, 0.9, 0.9), "roughness": 0.4, "transmission": 1.0}])
def test_surface_bsdf_equals_the_oracle(material):
    from oracle import surface_bsdf as osb

    from perfbench.reference import bsdf
    from perfbench.reference import scene as rscene
    rng = np.random.default_rng(1)
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    wo[:, 2] = np.abs(wo[:, 2])
    p = {k: _t(np.broadcast_to(np.asarray(v, np.float64),
                               (N,) + np.shape(v)))
         for k, v in rscene._material({"material": material}).items()}
    om = osb.make_material(**material)
    assert _rel(bsdf.surface_f(p, _t(wo), _t(wi)).numpy(),
                osb.surface_f(om, wo, wi)) < 1e-12
    assert _rel(bsdf.surface_pdf(p, _t(wo), _t(wi)).numpy(),
                osb.surface_pdf(om, wo, wi)) < 1e-12


def test_env_map_equals_the_oracle():
    from types import SimpleNamespace

    from oracle.envmap import EnvMap

    from perfbench.reference import bsdf
    from perfbench.reference import scene as rscene
    image = tiny_scene("bunny5")[0]["env_map"]
    ora = EnvMap(image)
    sc = SimpleNamespace(**dict(zip(
        ("env_map", "env_pmf", "env_cdf", "env_sin"),
        (_t(a) for a in rscene._env_tables(image)))))
    rng = np.random.default_rng(2)
    d = _dirs(rng, N)
    assert _rel(bsdf.env_eval(sc, _t(d)).numpy(), ora.eval(d)) < 1e-12
    assert _rel(bsdf.env_pdf(sc, _t(d)).numpy(), ora.pdf(d)) < 1e-12
    u1, u2 = rng.random(N), rng.random(N)
    wi, pdf = bsdf.env_sample(sc, _t(u1), _t(u2))
    wi_o, pdf_o = ora.sample(u1, u2)
    assert _rel(wi.numpy(), wi_o) < 1e-12 and _rel(pdf.numpy(), pdf_o) < 1e-12


def _round_segments(scene):
    """The oracle's scene with the segments rounded to float32, as the
    reference (and the program) take them."""
    return dict(scene, segments=tuple(
        np.asarray(a, np.float64).astype(np.float32).astype(np.float64)
        for a in scene["segments"]))


CONFIGS = [c["name"] for c in bench()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_paths_equal_the_oracle(name):
    """Every ray of a 24x24, 2-spp, depth-4 image, from the oracle's
    camera and one uniforms array: hair, the sphere, the bunny's
    triangles and plane, point lights, the env map's MIS and Russian
    roulette from bounce 3."""
    from oracle import geometry as geo
    from oracle import pathtrace as opt

    from perfbench.reference import scene as rscene
    from perfbench.reference import tracer
    scene, cam = tiny_scene(name)
    res, spp, depth = 24, 2, 4
    rng = np.random.default_rng(3)
    u = rng.random((res * res * spp, opt.n_uniform_dims(depth)))
    jj, ii = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    i, j = np.repeat(ii.reshape(-1), spp), np.repeat(jj.reshape(-1), spp)
    o, d = geo.camera_rays(dict(cam, width=res, height=res), i, j, u[:, :4])
    o_r, d_r = tracer.camera_rays(cam, res, res, _t(i), _t(j), _t(u[:, :4]),
                                  torch.float64)
    assert _rel(o_r.numpy(), o) < 1e-6 and _rel(d_r.numpy(), d) < 1e-6
    want = opt.trace(_round_segments(scene), o, d, u, max_depth=depth)
    sc = rscene.from_dict(scene, torch.device("cpu"), torch.float64)
    got = tracer.trace(sc, _t(o), _t(d), _t(u), depth).numpy()
    gap = np.abs(got - want)
    mean = want.mean()
    assert np.isfinite(got).all() and mean > 0
    assert gap.mean() < 1e-5 * mean
    assert np.quantile(gap.max(1), 0.995) < 1e-4 * mean
    assert gap.max() < 1e-2 * mean
