"""Port vs reference: per-shape hair materials.

The two-wig scene of ``tests/test_hair_materials.py`` (two curly wigs,
each with its own row of a two-row hair-material table). The port's
scene holds the table and the per-segment ids as the reference's does,
and ``build_scene_clusters`` carries the ids into cluster order.

Renders (12x12, 1 spp, depth 2) through the port's brute-force scan and
its cluster search (plain kernels) against eager JAX by brute force on
the same uniforms: max |diff| < 1e-4 on >= 99% of the pixels and mean
|diff| < 1e-5, as ``tests/test_torch_render.py`` holds a one-material
render (measured max 1.5e-8 on both paths); both wigs must show, and
the table's second row must change the image. The gradient of
sum(W * image) with respect to the table rows of beta_m, beta_n and
sigma_a against eager ``jax.grad``: rtol 1e-4 (measured 5.8e-6,
beta_m), and every row receives gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle.hair_bsdf import sigma_a_from_concentration
from scenes import generators as gen
from yhair_tpu.core import scene as jscene
from yhair_tpu.integrator import path as jpath
from yhair_tpu_torch import convert
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.ops import build_scene_clusters

torch.set_num_threads(1)

PARAMS = ("beta_m", "beta_n", "sigma_a")
RES, SPP, DEPTH = 12, 1, 2


def two_wigs():
    """``tests/test_hair_materials.py:_two_wig_scene``."""
    a, cam = gen.curly_hairball(n_strands=50, n_seg=6)
    b, _ = gen.curly_hairball(n_strands=50, n_seg=6, seed=7)
    off = np.array([0.55, 0.0, 0.0])
    pa, pb = a["segments"], b["segments"]
    segs = (np.concatenate([pa[0] - off, pb[0] + off]),
            np.concatenate([pa[1] - off, pb[1] + off]),
            np.concatenate([pa[2], pb[2]]), np.concatenate([pa[3], pb[3]]))
    mats = [{"sigma_a": sigma_a_from_concentration(1.3, 0.1),
             "beta_m": 0.25, "beta_n": 0.3},
            {"sigma_a": sigma_a_from_concentration(0.1, 0.6),
             "beta_m": 0.45, "beta_n": 0.35}]
    scene = dict(a, segments=segs, hair_materials=mats,
                 segment_mat_id=np.concatenate(
                     [np.zeros(len(pa[0]), np.int64),
                      np.ones(len(pb[0]), np.int64)]))
    return scene, dict(cam, position=np.asarray(cam["position"]) * 1.6)


@pytest.fixture(scope="module")
def wigs():
    scene_d, cam_d = two_wigs()
    sc = tscene.from_dict(scene_d, device="cpu")
    sc_cl, _ = build_scene_clusters(sc, device="cpu")
    return (scene_d, cam_d, {"brute": sc, "cluster": sc_cl},
            tscene.camera_from_dict(cam_d, device="cpu"))


def _uniforms(seed):
    return np.random.default_rng(seed).random(
        (RES, RES, SPP, n_uniform_dims(DEPTH))).astype(np.float32)


def _reference(scene_d, cam_d, u, params=None):
    jsc = jscene.from_dict(scene_d)
    if params is not None:
        jsc = jsc._replace(hair=jsc.hair._replace(**params))
    return jpath.render(jsc, jscene.camera_from_dict(cam_d), jnp.asarray(u),
                        max_depth=DEPTH, chunk=4096)


def test_table_and_ids_match_reference(wigs):
    scene_d, _, scs, _ = wigs
    sc = scs["brute"]
    assert tuple(sc.hair.beta_m.shape) == (2,)
    assert tuple(sc.hair.sigma_a.shape) == (2, 3)
    jsc = jscene.from_dict(scene_d)
    for k in sc.hair._fields:
        np.testing.assert_array_equal(getattr(sc.hair, k).numpy(),
                                      np.asarray(getattr(jsc.hair, k)), k)
    np.testing.assert_array_equal(sc.seg_mat_id.numpy(),
                                  np.asarray(jsc.seg_mat_id))
    # cluster order: each real segment keeps its wig's row, padding gets 0
    sc_cl = scs["cluster"]
    sidx = sc_cl.accel.seg_index.numpy()
    want = np.where(sidx >= 0, np.asarray(scene_d["segment_mat_id"])[
        np.maximum(sidx, 0)], 0)
    np.testing.assert_array_equal(sc_cl.seg_mat_id.numpy(), want)
    assert set(np.unique(want)) == {0, 1}


@pytest.mark.parametrize("path", ["brute", "cluster"])
def test_two_wig_render_matches_eager_reference(wigs, path):
    scene_d, cam_d, scs, cam = wigs
    u = _uniforms(2)
    with jax.disable_jit():
        want = np.asarray(_reference(scene_d, cam_d, u))
    got = tpath.render(scs[path], cam, torch.as_tensor(u), max_depth=DEPTH,
                       device="cpu").numpy()
    diff = np.abs(got - want)
    assert np.isfinite(got).all()
    assert (diff.max(-1) < 1e-4).mean() >= 0.99
    assert diff.mean() < 1e-5
    # both wigs show, and the second row changes the right wig
    half = RES // 2
    assert got[:, :half].mean() > 0.01 and got[:, half:].mean() > 0.01
    mono = scs[path]._replace(hair=type(scs[path].hair)(
        *(a[0] for a in scs[path].hair)))
    img_m = tpath.render(mono, cam, torch.as_tensor(u), max_depth=DEPTH,
                         device="cpu").numpy()
    assert np.abs(img_m[:, half:] - got[:, half:]).max() > 1e-3


def test_table_gradients_match_eager_reference(wigs):
    scene_d, cam_d, scs, cam = wigs
    u = _uniforms(0)
    w = np.random.default_rng(1).random((RES, RES, 3)).astype(np.float32)
    sc = scs["cluster"]
    p0 = {k: getattr(sc.hair, k).numpy() for k in PARAMS}
    params = convert.params_from_numpy(p0, device="cpu")
    img = tpath.render(sc._replace(hair=sc.hair._replace(**params)), cam,
                       torch.as_tensor(u), max_depth=DEPTH, device="cpu")
    (torch.as_tensor(w) * img).double().sum().backward()

    def loss(p):
        return (jnp.asarray(w) * _reference(scene_d, cam_d, u, p)).sum()
    with jax.disable_jit():
        want = jax.grad(loss)({k: jnp.asarray(v) for k, v in p0.items()})
    for k in PARAMS:
        got = params[k].grad.numpy()
        assert got.shape[0] == 2 and np.isfinite(got).all(), k
        # both wigs are visible, so every row receives gradient
        assert (np.abs(got).reshape(2, -1).sum(-1) > 1e-3).all(), k
        np.testing.assert_allclose(got, np.asarray(want[k]), rtol=1e-4,
                                   err_msg=k)
