"""Port vs reference: the forward render as a whole, the state hand-over,
the render entry point and the device rule.

The port renders the small hairball through its cluster search (the
plain versions of the CUDA kernels on the CPU); the reference renders it
by brute force on the same uniforms. Run eagerly, the reference agrees
to f32 rounding on almost every pixel (the BSDF's transcendentals differ
by ulps between XLA and ATen, so a path whose discrete choice sits
within an ulp of its threshold can diverge): max |diff| < 1e-4 on >= 99%
of the pixels and mean |diff| < 1e-5. Under jit, XLA contracts the
closest approach and the shading into FMAs, which flips such choices on
about 2% of the pixels at depth 3 (measured 4 and 5 of 256 on two
seeds, none at depth 1): >= 97% of the pixels within 1e-4 and mean
|diff| < 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.core import scene as jscene
from yhair_tpu.integrator import path as jpath
from yhair_tpu.ops import build_scene_clusters as jbuild_scene_clusters
from yhair_tpu_torch import convert
from yhair_tpu_torch.accel import instanced
from yhair_tpu_torch.accel.instanced import build_instanced
from yhair_tpu_torch.apps import invert
from yhair_tpu_torch.apps import render as app
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.device import resolve_device
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.ops import build_scene_clusters
from yhair_tpu_torch.ops import intersect_kernel as ik
from yhair_tpu_torch.parallel import mesh

torch.set_num_threads(1)

RES, SPP, DEPTH = 16, 2, 3


@pytest.fixture(scope="module")
def hairball():
    scene_d, cam_d = gen.curly_hairball(n_strands=300, n_seg=8)
    sc = tscene.from_dict(scene_d, device="cpu")
    sc2, _ = build_scene_clusters(sc, device="cpu")
    cam = tscene.camera_from_dict(cam_d, device="cpu")
    return scene_d, cam_d, sc2, cam


def _uniforms(seed, res=RES, spp=SPP, depth=DEPTH):
    rng = np.random.default_rng(seed)
    return rng.random((res, res, spp, n_uniform_dims(depth))).astype(
        np.float32)


@pytest.mark.parametrize("mode,px_frac,mean_tol", [
    ("eager", 0.99, 1e-5), ("jit", 0.97, 5e-4)])
def test_render_matches_reference(hairball, mode, px_frac, mean_tol):
    scene_d, cam_d, sc2, cam = hairball
    u = _uniforms(0)

    def ref(s, c, uu):
        return jpath.render(s, c, uu, max_depth=DEPTH, chunk=4096)
    args = (jscene.from_dict(scene_d), jscene.camera_from_dict(cam_d),
            jnp.asarray(u))
    if mode == "jit":
        want = np.asarray(jax.jit(ref)(*args))
    else:
        with jax.disable_jit():
            want = np.asarray(ref(*args))
    got = tpath.render(sc2, cam, torch.as_tensor(u), max_depth=DEPTH,
                       device="cpu").numpy()
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert (diff.max(-1) < 1e-4).mean() >= px_frac
    assert diff.mean() < mean_tol


def test_sorted_wavefront_is_bit_identical(hairball):
    """The Morton sort only reorders the search: same image, bit for bit."""
    _, _, sc2, cam = hairball
    u = torch.as_tensor(_uniforms(1, res=24))
    hgt = wid = 24
    jj, ii = torch.meshgrid(torch.arange(hgt), torch.arange(wid),
                            indexing="ij")
    i = ii.reshape(-1).repeat_interleave(SPP).float()
    j = jj.reshape(-1).repeat_interleave(SPP).float()
    uf = u.reshape(hgt * wid * SPP, -1)
    from yhair_tpu_torch.core.camera import camera_rays
    o, d = camera_rays(cam, wid, hgt, i, j, uf[:, :4])
    a = tpath.trace(sc2, o, d, uf, max_depth=DEPTH, sort_rays=True,
                    device="cpu")
    b = tpath.trace(sc2, o, d, uf, max_depth=DEPTH, sort_rays=False,
                    device="cpu")
    assert torch.equal(a, b)


def test_scene_from_numpy_round_trip(hairball):
    """A reference Scene handed over as numpy equals the port's own
    build of the same scene dict, field for field."""
    scene_d, _, sc2, _ = hairball
    jsc2, _, _ = jbuild_scene_clusters(jscene.from_dict(scene_d))
    got = convert.scene_from_numpy(convert.flat_fields(jsc2), device="cpu")
    want = convert.flat_fields(sc2)
    for name, v in convert.flat_fields(got).items():
        assert name in want, name
        np.testing.assert_array_equal(v, want[name], err_msg=name)


def test_render_cli_writes_pfm(tmp_path):
    """The entry point end to end on the CPU, at a tiny size."""
    out = tmp_path / "x.pfm"
    app.main(["--config", "1", "--resolution", "16", "--spp", "1",
              "--bounces", "2", "--output", str(out), "--device", "cpu"])
    img = app.load_pfm(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.max() > 0


def test_progressive_render_matches_reference_uniforms(hairball):
    """The tile-permuted strips use the reference's counter-hash uniforms:
    the progressive image equals ``render`` on those uniforms."""
    _, _, sc2, cam = hairball
    img = app.progressive_render(sc2, cam, RES, RES, SPP, DEPTH, seed=3,
                                 max_rays_per_call=128, log=None,
                                 device="cpu")
    pix = torch.arange(RES * RES).repeat_interleave(SPP)
    smp = torch.arange(SPP).repeat(RES * RES)
    u = mesh.ray_uniforms(mesh.key_seed(3), pix, smp, DEPTH)
    want = tpath.render(sc2, cam, u.reshape(RES, RES, SPP, -1),
                        max_depth=DEPTH, device="cpu").numpy()
    np.testing.assert_allclose(img, want, rtol=1e-6, atol=1e-7)


def test_entry_points_need_a_card_unless_asked_for_cpu(hairball):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    scene_d, cam_d, sc2, cam = hairball
    u = torch.as_tensor(_uniforms(2))
    ic = build_instanced(sc2.accel, [np.eye(4, 3)], device="cpu")
    calls = [
        lambda: resolve_device(None),
        lambda: tscene.from_dict(scene_d),
        lambda: build_scene_clusters(sc2),
        lambda: ik.make_nearest_fn(sc2.accel),
        lambda: tpath.render(sc2, cam, u, max_depth=DEPTH),
        lambda: app.progressive_render(sc2, cam, RES, RES, 1, DEPTH,
                                       log=None),
        lambda: app.main(["--config", "1", "--output", "unused.npy"]),
        lambda: mesh.train_step_fn(RES, RES, 1, DEPTH),
        lambda: invert.main(["--config", "1", "--out", "unused.json"]),
        lambda: build_instanced(sc2.accel, [np.eye(4, 3)]),
        lambda: instanced.make_nearest_fn(ic),
        lambda: instanced.make_occluded_fn(ic),
        lambda: convert.instanced_from_numpy(convert.flat_fields(ic)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("feature", ["curves", "hair_materials"])
def test_from_dict_refuses_unsupported_features(hairball, feature):
    """Curves and hair-material tables render now
    (``tests/test_torch_curves.py``, ``tests/test_torch_hair_materials.py``);
    what the port cannot render is a malformed one: control points that
    are not (C, 4, 3), a table without its per-segment ids."""
    scene_d = dict(hairball[0])
    extra = {
        "curves": {"curves": {"cp": np.zeros((1, 3, 3)), "r0": 0.01,
                              "r1": 0.01}},
        "hair_materials": {"hair_materials": [scene_d["hair_material"]]},
    }[feature]
    scene_d.update(extra)
    with pytest.raises(ValueError):
        tscene.from_dict(scene_d, device="cpu")


def _backdrop(material):
    """A 3x3 quad behind the hairball, with texcoords."""
    return {"positions": np.array([[-1.5, -1.5, -0.8], [1.5, -1.5, -0.8],
                                   [1.5, 1.5, -0.8], [-1.5, 1.5, -0.8]]),
            "triangles": np.array([[0, 1, 2], [0, 2, 3]]),
            "texcoords": np.array([[0, 0], [1, 0], [1, 1], [0, 1.0]]),
            "material": material}


@pytest.mark.parametrize("feature", [
    "meshes", "env_map", "textures", "emissive sphere", "textured material"])
def test_from_dict_renders_ported_features(hairball, feature):
    """The features the port once refused render like the eager
    reference (same tolerance as ``test_render_matches_reference``)."""
    scene_d, cam_d = dict(hairball[0]), hairball[1]
    tex = [{"data": np.random.default_rng(1).random((4, 6, 3))}]
    extra = {
        "meshes": {"meshes": [_backdrop({"color": [0.4, 0.5, 0.6]})]},
        "env_map": {"env_map": np.random.default_rng(2).random((4, 8, 3))},
        "textures": {"textures": tex, "meshes": [_backdrop(
            {"color": [0.9, 0.9, 0.9], "color_tex": 0})]},
        "emissive sphere": {"spheres": [{
            "center": [0.0, 0.0, 0.0], "radius": 0.2,
            "material": {"emission": [1.0, 1.0, 1.0]}}]},
        "textured material": {"textures": tex, "spheres": [{
            "center": [0.0, 0.0, 0.0], "radius": 0.2,
            "material": {"color": [0.5, 0.5, 0.5], "color_tex": 0}}]},
    }[feature]
    scene_d.update(extra)
    sc2, _ = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                  device="cpu")
    u = _uniforms(4)
    with jax.disable_jit():
        want = np.asarray(jpath.render(
            jscene.from_dict(scene_d), jscene.camera_from_dict(cam_d),
            jnp.asarray(u), max_depth=DEPTH, chunk=4096))
    got = tpath.render(sc2, tscene.camera_from_dict(cam_d, device="cpu"),
                       torch.as_tensor(u), max_depth=DEPTH,
                       device="cpu").numpy()
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert (diff.max(-1) < 1e-4).mean() >= 0.99
    assert diff.mean() < 1e-5
