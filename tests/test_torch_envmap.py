"""Port vs reference: the environment map and textures.

(a) The sampling tables of ``from_dict`` (image, pmf, cdf, sin theta) are
    bit-equal to the reference's: both build them in float64 and cast.
(b) ``env_eval``, ``env_pdf``, ``direction_to_texel`` and ``env_sample``
    against eager JAX on random directions and uniforms. The texel index
    and the pdf are compared exactly (ATen's and XLA's atan2/acos differ
    by an ulp at most, which moves no direction of these seeds across a
    texel edge); radiance to rtol 1e-5 (measured 1.6e-6) and sampled
    directions to atol 1e-6 (measured 1.2e-7).
(c) Texture lookups against eager JAX, with u from -1.5 to 2.5 (the
    wrap, where the int conversion truncates and % floors) and v outside
    [0, 1] (the clamp): equal to rtol 1e-6 (measured 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle.envmap import EnvMap, gradient_sky
from oracle.texture import checkerboard, uv_gradient
from scenes import generators as gen
from yhair_tpu.bsdf import surface as js
from yhair_tpu.core import envmap as jenv
from yhair_tpu.core import scene as jscene
from yhair_tpu.core import texture as jtex
from yhair_tpu_torch.bsdf import surface as ts
from yhair_tpu_torch.core import envmap as tenv
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core import texture as ttex

torch.set_num_threads(1)

ENV_FIELDS = ("env_map", "env_pmf", "env_cdf", "env_sin")


@pytest.fixture(scope="module")
def scenes():
    scene_d, _ = gen.single_strand()
    scene_d = dict(scene_d, env_map=gradient_sky(h=16, w=32))
    return jscene.from_dict(scene_d), tscene.from_dict(scene_d, device="cpu")


@pytest.mark.parametrize("source", ["image", "EnvMap", "black"])
def test_env_tables_are_the_references(source):
    scene_d, _ = gen.single_strand()
    sky = gradient_sky(h=8, w=16)
    env = {"image": sky, "EnvMap": EnvMap(sky),
           "black": np.zeros((4, 8, 3))}[source]
    jsc = jscene.from_dict(dict(scene_d, env_map=env))
    tsc = tscene.from_dict(dict(scene_d, env_map=env), device="cpu")
    for k in ENV_FIELDS:
        np.testing.assert_array_equal(getattr(tsc, k).numpy(),
                                      np.asarray(getattr(jsc, k)), k)
    assert tenv.has_env(tsc)


def test_no_env_map_is_empty():
    scene_d, _ = gen.single_strand()
    tsc = tscene.from_dict(scene_d, device="cpu")
    assert not tenv.has_env(tsc)
    assert tuple(tsc.env_map.shape) == (0, 0, 3)


def _dirs(seed, n=2048):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # the poles and the u seam
    v[:4] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [-1, 0, 1e-7]]
    return v.astype(np.float32)


def test_env_eval_pdf_and_texel_match_reference(scenes):
    jsc, tsc = scenes
    d = _dirs(0)
    with jax.disable_jit():
        jd = jnp.asarray(d)
        want_l = np.asarray(jenv.env_eval(jsc, jd))
        want_p = np.asarray(jenv.env_pdf(jsc, jd))
        want_xy = [np.asarray(a) for a in jenv.direction_to_texel(jsc, jd)]
    td = torch.as_tensor(d)
    got_xy = [a.numpy() for a in tenv.direction_to_texel(tsc, td)]
    for g, w in zip(got_xy, want_xy):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tenv.env_pdf(tsc, td).numpy(), want_p)
    np.testing.assert_allclose(tenv.env_eval(tsc, td).numpy(), want_l,
                               rtol=1e-5, atol=0)


def test_env_sample_matches_reference(scenes):
    jsc, tsc = scenes
    rng = np.random.default_rng(1)
    u1, u2 = rng.random((2, 4096)).astype(np.float32)
    # exactly on CDF values (searchsorted's side) and the ends
    cdf = tsc.env_cdf.numpy()
    u1[:6] = [0.0, 1.0, cdf[0], cdf[7], cdf[100], 0.9999999]
    with jax.disable_jit():
        wd, wp = (np.asarray(a) for a in jenv.env_sample(
            jsc, jnp.asarray(u1), jnp.asarray(u2)))
    gd, gp = tenv.env_sample(tsc, torch.as_tensor(u1), torch.as_tensor(u2))
    np.testing.assert_array_equal(gp.numpy(), wp)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-5, atol=1e-6)
    # a sampled direction's pdf is the pdf the miss branch evaluates
    np.testing.assert_allclose(tenv.env_pdf(tsc, gd).numpy(), gp.numpy(),
                               rtol=1e-6)


TEXTURES = [checkerboard(16, 24, tiles=4), uv_gradient(9, 7)]


def _uvs(seed, n=600):
    rng = np.random.default_rng(seed)
    u = (rng.random(n) * 4.0 - 1.5).astype(np.float32)
    v = (rng.random(n) * 1.6 - 0.3).astype(np.float32)
    u[:4] = [-1.0, -0.5, -1e-3, 1.0]
    return u, v


def test_flatten_textures_matches_reference():
    jd, jm = jtex.flatten_textures(TEXTURES)
    td, tm = ttex.flatten_textures(TEXTURES)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.dtype == torch.int32
    ed, em = ttex.flatten_textures([])
    assert tuple(ed.shape) == (0, 3) and tuple(em.shape) == (0, 3)


def test_sample_bilinear_matches_reference():
    jd, jm = jtex.flatten_textures(TEXTURES)
    td, tm = ttex.flatten_textures(TEXTURES)
    u, v = _uvs(2)
    tid = np.random.default_rng(3).integers(-1, 2, u.shape[0]).astype(
        np.int32)
    with jax.disable_jit():
        want = np.asarray(jtex.sample_bilinear(
            jd, jm, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v)))
    got = ttex.sample_bilinear(td, tm, torch.as_tensor(tid),
                               torch.as_tensor(u), torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.numpy()[tid < 0], 1.0)


def test_apply_textures_matches_reference():
    mats = [{"color": [0.5, 0.6, 0.7], "roughness": 0.8, "color_tex": 0,
             "roughness_tex": 1},
            {"emission": [2.0, 1.0, 0.5], "emission_tex": 1},
            {"color": [0.2, 0.2, 0.2]}]
    idx = np.random.default_rng(4).integers(0, 3, 600)
    u, v = _uvs(5)
    uv = np.stack([u, v], -1)
    jd, jm = jtex.flatten_textures(TEXTURES)
    td, tm = ttex.flatten_textures(TEXTURES)
    with jax.disable_jit():
        want = jtex.apply_textures(
            jd, jm, js.SurfaceMaterial.make(mats).gather(jnp.asarray(idx)),
            jnp.asarray(uv))
    got = ttex.apply_textures(
        td, tm, ts.SurfaceMaterial.make(mats).gather(torch.as_tensor(idx)),
        torch.as_tensor(uv))
    for k in ts.SurfaceMaterial._fields:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=0, err_msg=k)
