"""Port vs reference: config 5's lights and meshes, as a whole.

Scenes: a small config 5 (``furry_bunny(n_strands=200, subdiv=1)``: 1,200
hair segments on a 320-triangle bunny, a plane, a point light and a
16x32 environment map, so every bounce does env NEE with MIS and the
miss branch weighs the env map against the BSDF sample); the area-light
scene of ``tests/test_area_lights.py`` (an emissive sphere and an
emissive quad: area NEE, the emission MIS weight); a textured scene
(color, roughness and emission textures on spheres, a plane and a quad
with texcoords, so NEE reads the textured emission); and the small
config 5 with ``sampler="naive"``.

Renders: the port through its cluster search (plain kernels) against the
reference by brute force on the same uniforms. Eagerly (8x8, 1 spp,
depth 2; every case, and ``sampler="eyelight"`` on the textured scene)
they agree to f32 rounding: max |diff| < 1e-4 on >= 99% of the pixels
and mean |diff| < 1e-5 (measured max 4.8e-7, mean 7e-9). Jitted (16x16,
2 spp, depth 3; config 5 and naive), XLA's FMA contraction can move a
path: >= 97% of the pixels within 1e-4 and mean |diff| < 5e-4 (measured
max 2.3e-5, every pixel within).

The gradient of sum(W * image) with respect to beta_m, beta_n and
sigma_a on the small config 5 at depth 2 against eager ``jax.grad``:
env NEE with MIS on every bounce, whose weight holds a detached hair
pdf, so the gradient is jax.grad's and not a finite difference of the
image. rtol 1e-4 (measured 6.5e-6, beta_m). Eager JAX's cost is mostly
compiling each primitive once: the first eager render of this file
takes about 25 s, the others 1-5 s, the gradient about 25 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle.envmap import gradient_sky
from oracle.texture import checkerboard, uv_gradient
from scenes import generators as gen
from yhair_tpu.core import scene as jscene
from yhair_tpu.integrator import path as jpath
from yhair_tpu.ops import build_scene_clusters as jbuild_scene_clusters
from yhair_tpu_torch import convert
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.ops import build_scene_clusters

torch.set_num_threads(1)

PARAMS = ("beta_m", "beta_n", "sigma_a")


def _quad(p, ex, ey, material, texcoords=False):
    p = np.asarray(p, np.float64)
    mesh = {"positions": np.stack([p, p + ex, p + ex + ey, p + ey]),
            "triangles": np.array([[0, 1, 2], [0, 2, 3]]),
            "material": material}
    if texcoords:
        mesh["texcoords"] = np.array([[0, 0], [1, 0], [1, 1], [0, 1.0]])
    return mesh


def config5():
    scene, cam = gen.furry_bunny(n_strands=200, subdiv=1)
    return dict(scene, env_map=gradient_sky(h=16, w=32)), cam


def area_lights():
    """``tests/test_area_lights.py:_light_scene``."""
    scene, cam = gen.single_strand()
    return dict(
        scene, point_lights=[], environment=np.zeros(3),
        meshes=[_quad([-0.3, 0.45, -0.3], np.array([0.6, 0.0, 0.0]),
                      np.array([0.0, 0.0, 0.6]),
                      {"emission": [6.0, 5.0, 4.0], "color": [0, 0, 0]})],
        spheres=[{"center": [0.35, 0.0, 0.0], "radius": 0.06,
                  "material": {"emission": [3.0, 6.0, 9.0],
                               "color": [0, 0, 0]}}],
        planes=[{"point": [0, -0.4, 0], "normal": [0, 1, 0],
                 "albedo": [0.6, 0.55, 0.5]}]), cam


def textured():
    scene, cam = gen.single_strand()
    return dict(
        scene,
        textures=[{"data": checkerboard(32, 32, tiles=6)},
                  {"data": uv_gradient(16, 16)}],
        spheres=[{"center": [0.25, 0.0, -0.2], "radius": 0.18,
                  "material": {"color": [0.9, 0.9, 0.9], "roughness": 0.4,
                               "color_tex": 0}},
                 {"center": [-0.3, 0.1, -0.1], "radius": 0.12,
                  "material": {"emission": [4.0, 4.0, 4.0],
                               "color": [0, 0, 0], "emission_tex": 1}}],
        planes=[{"point": [0, -0.4, 0], "normal": [0, 1, 0],
                 "material": {"color": [0.6, 0.6, 0.6], "roughness": 0.9,
                              "color_tex": 1, "roughness_tex": 1}}],
        meshes=[_quad([-0.3, 0.4, -0.5], np.array([0.6, 0.0, 0.0]),
                      np.array([0.0, 0.0, 0.4]),
                      {"emission": [3.0, 3.0, 3.0], "color": [0.5, 0.5, 0.5],
                       "emission_tex": 0}, texcoords=True)]), cam


def curves():
    """The single strand as one first-class curve beside its segments."""
    scene, cam = gen.single_strand()
    cp = np.array([[[0.0, -0.5, 0.0], [0.25, -0.1, 0.1],
                    [-0.2, 0.3, -0.05], [0.1, 0.6, 0.0]]]) + [0.3, 0, 0]
    return dict(scene, curves={"cp": cp, "r0": [0.02], "r1": [0.008],
                               "mat_id": [1]},
                hair_materials=[scene["hair_material"], dict(
                    scene["hair_material"], beta_m=0.5)],
                segment_mat_id=np.zeros(len(scene["segments"][0]))), cam


SCENES = {"config5": config5, "area_lights": area_lights,
          "textured": textured, "curves_and_table": curves}
# case -> (scene, sampler)
CASES = {"config5": ("config5", "path"),
         "area_lights": ("area_lights", "path"),
         "textured": ("textured", "path"), "naive": ("config5", "naive"),
         "eyelight": ("textured", "eyelight")}


@pytest.fixture(scope="module")
def built():
    """{scene name: (scene dict, camera dict, port scene, port camera)}"""
    out = {}
    for name, fn in SCENES.items():
        scene_d, cam_d = fn()
        sc2, _ = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                      device="cpu")
        out[name] = (scene_d, cam_d, sc2,
                     tscene.camera_from_dict(cam_d, device="cpu"))
    return out


def test_small_config5_has_what_config5_has(built):
    _, _, sc2, _ = built["config5"]
    assert sc2.n_triangles == 320 and tuple(sc2.env_map.shape) == (16, 32, 3)
    assert sc2.n_lights == 1 and sc2.n_planes == 1 and sc2.n_spheres == 0
    # the bunny is the last material: spheres, then planes, then meshes
    assert int(sc2.tris.mat_id[0]) == 1 and sc2.surf_mat.color.shape[0] == 2


def test_full_config5_scene():
    """Config 5 at full size: 300,000 segments, 800 triangles, a 64x128
    environment map, one point light, one plane, no area lights."""
    sc = tscene.from_dict(gen.furry_bunny()[0], device="cpu")
    assert sc.segments.p0.shape[0] == 300000 and sc.n_triangles == 800
    assert tuple(sc.env_map.shape) == (64, 128, 3)
    assert (sc.n_lights, sc.n_planes, sc.n_area_lights) == (1, 1, 0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_numpy_round_trip(built, name):
    """A reference Scene handed over as numpy equals the port's own build
    of the same scene dict, field for field."""
    scene_d, _, sc2, _ = built[name]
    jsc2, _, _ = jbuild_scene_clusters(jscene.from_dict(scene_d))
    got = convert.scene_from_numpy(convert.flat_fields(jsc2), device="cpu")
    want = convert.flat_fields(sc2)
    fields = convert.flat_fields(got)
    assert set(fields) == set(want)
    for k, v in fields.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def _render_pair(built, case, mode, res, spp, depth):
    """(port image, reference image) of a case on uniforms from a seed."""
    name, sampler = CASES[case]
    scene_d, cam_d, sc2, cam = built[name]
    u = np.random.default_rng(len(case)).random(
        (res, res, spp, n_uniform_dims(depth))).astype(np.float32)

    def ref(s, c, uu):
        return jpath.render(s, c, uu, max_depth=depth, chunk=4096,
                            sampler=sampler)
    args = (jscene.from_dict(scene_d), jscene.camera_from_dict(cam_d),
            jnp.asarray(u))
    if mode == "jit":
        want = np.asarray(jax.jit(ref)(*args))
    else:
        with jax.disable_jit():
            want = np.asarray(ref(*args))
    got = tpath.render(sc2, cam, torch.as_tensor(u), max_depth=depth,
                       sampler=sampler, device="cpu").numpy()
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_eager_reference(built, case):
    got, want = _render_pair(built, case, "eager", 8, 1, 2)
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert (diff.max(-1) < 1e-4).mean() >= 0.99
    assert diff.mean() < 1e-5


def test_render_gradients_match_eager_reference(built):
    """The small config 5 at depth 2: env NEE with MIS on every bounce."""
    scene_d, cam_d, sc2, cam = built["config5"]
    res, depth = 8, 2
    rng = np.random.default_rng(5)
    u = rng.random((res, res, 1, n_uniform_dims(depth))).astype(np.float32)
    w = rng.random((res, res, 3)).astype(np.float32)
    m = scene_d["hair_material"]
    p0 = {k: np.asarray(m[k], np.float32) for k in PARAMS}

    params = convert.params_from_numpy(p0, device="cpu")
    img = tpath.render(sc2._replace(hair=sc2.hair._replace(**params)), cam,
                       torch.as_tensor(u), max_depth=depth, device="cpu")
    (torch.as_tensor(w) * img).double().sum().backward()

    jsc = jscene.from_dict(scene_d)
    jcam = jscene.camera_from_dict(cam_d)

    def loss(p):
        sc = jsc._replace(hair=jsc.hair._replace(**p))
        img = jpath.render(sc, jcam, jnp.asarray(u), max_depth=depth,
                           chunk=4096)
        return (jnp.asarray(w) * img).sum()
    with jax.disable_jit():
        want = jax.grad(loss)({k: jnp.asarray(v) for k, v in p0.items()})
    for k in PARAMS:
        got = params[k].grad.numpy()
        assert np.isfinite(got).all() and np.abs(got).min() > 1e-2, k
        np.testing.assert_allclose(got, np.asarray(want[k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["config5", "naive"])
def test_render_matches_jitted_reference(built, case):
    got, want = _render_pair(built, case, "jit", 16, 2, 3)
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert (diff.max(-1) < 1e-4).mean() >= 0.97
    assert diff.mean() < 5e-4


def test_endpoint_gradient_matches_eager_reference(built):
    """The gradient of sum(W * image) with respect to the hair segments'
    p0 on the small config 5 at depth 2: hair hits move the next rays'
    origins, whose triangle hits are recomputed on the winning triangle
    (the triangle search itself is detached). The port's cluster-order
    rows are taken back to the scene's order. rtol 1e-3 on the entries
    above 1% of the largest, atol 1e-5 of it elsewhere."""
    scene_d, cam_d, sc2, cam = built["config5"]
    res, depth = 8, 2
    # at 8x8 few rays meet hair: this seed's reach four segments
    rng = np.random.default_rng(2)
    u = rng.random((res, res, 1, n_uniform_dims(depth))).astype(np.float32)
    w = rng.random((res, res, 3)).astype(np.float32)
    p0 = sc2.segments.p0.clone().requires_grad_(True)
    img = tpath.render(sc2._replace(segments=sc2.segments._replace(p0=p0)),
                       cam, torch.as_tensor(u), max_depth=depth, device="cpu")
    (torch.as_tensor(w) * img).double().sum().backward()
    sidx = sc2.accel.seg_index.numpy()
    got = np.zeros((int(sidx.max()) + 1, 3), np.float32)
    got[sidx[sidx >= 0]] = p0.grad.numpy()[sidx >= 0]

    jsc = jscene.from_dict(scene_d)
    jcam = jscene.camera_from_dict(cam_d)

    def loss(q):
        sc = jsc._replace(segments=jsc.segments._replace(p0=q))
        return (jnp.asarray(w) * jpath.render(sc, jcam, jnp.asarray(u),
                                              max_depth=depth,
                                              chunk=4096)).sum()
    with jax.disable_jit():
        want = np.asarray(jax.grad(loss)(jsc.segments.p0))
    scale = np.abs(want).max()
    big = np.abs(want) > 1e-2 * scale
    assert np.isfinite(got).all() and scale > 1e-3 and big.sum() >= 6
    np.testing.assert_allclose(got[big], want[big], rtol=1e-3)
    np.testing.assert_allclose(got[~big], want[~big], rtol=0,
                               atol=1e-5 * scale)
