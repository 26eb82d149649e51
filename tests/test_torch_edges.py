"""Port vs reference: soft silhouettes and geometry gradients.

After ``tests/test_edge_gradients.py:47,131``, on the 80-strand hair
patch (12x12, 1 spp, depth 2, the same uniforms), the port through its
brute-force scan and through its cluster search (plain kernels) against
eager JAX by brute force:
- the render with ``edge_softness`` = 0.4: max |diff| < 1e-4 on >= 99%
  of the pixels and mean |diff| < 1e-5 (measured max 1.7e-8: the band
  decisions agree), and it differs from the hard-edged render;
- d mean(image) / d radius scale, with soft silhouettes (the boundary
  term) and without (the interior term alone), against ``jax.grad``:
  rtol 1e-3 (measured 9.5e-7 soft, 3.7e-5 hard);
- d sum(W * image) / d segment endpoints p0 (soft silhouettes) against
  ``jax.grad``, the cluster path's rows taken back to the scene's order:
  rtol 1e-3 on entries above 1% of the largest (measured 8.1e-6), atol
  1e-5 of it elsewhere (measured 1.1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.core import scene as jscene
from yhair_tpu.integrator import path as jpath
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.ops import build_scene_clusters

torch.set_num_threads(1)

RES, SPP, DEPTH = 12, 1, 2
SOFT = 0.4


@pytest.fixture(scope="module")
def patch():
    scene_d, cam_d = gen.hair_patch(n_strands=80, n_seg=4)
    sc = tscene.from_dict(scene_d, device="cpu")
    sc_cl, _ = build_scene_clusters(sc, device="cpu")
    u = np.random.default_rng(0).random(
        (RES, RES, SPP, n_uniform_dims(DEPTH))).astype(np.float32)
    w = np.random.default_rng(1).random((RES, RES, 3)).astype(np.float32)
    return dict(scene_d=scene_d, cam_d=cam_d, u=u, w=w,
                scenes={"brute": sc, "cluster": sc_cl},
                cam=tscene.camera_from_dict(cam_d, device="cpu"), ref={})


def _port(p, sc, soft, segments=None):
    if segments is not None:
        sc = sc._replace(segments=segments)
    return tpath.render(sc, p["cam"], torch.as_tensor(p["u"]),
                        max_depth=DEPTH, edge_softness=soft, device="cpu")


def _reference(p, what):
    """Eager JAX by brute force, computed once per module."""
    if what in p["ref"]:
        return p["ref"][what]
    jsc = jscene.from_dict(p["scene_d"])
    jcam = jscene.camera_from_dict(p["cam_d"])
    u = jnp.asarray(p["u"])

    def render(segs, soft):
        return jpath.render(jsc._replace(segments=segs), jcam, u,
                            max_depth=DEPTH, chunk=4096, edge_softness=soft)

    def radius(soft):
        def mean_img(s):
            segs = jsc.segments._replace(r0=jsc.segments.r0 * s,
                                         r1=jsc.segments.r1 * s)
            return render(segs, soft).mean()
        return float(jax.grad(mean_img)(jnp.float32(1.0)))

    def endpoints(p0):
        return (jnp.asarray(p["w"]) * render(
            jsc.segments._replace(p0=p0), SOFT)).sum()
    with jax.disable_jit():
        p["ref"][what] = {
            "soft": lambda: np.asarray(render(jsc.segments, SOFT)),
            "radius_soft": lambda: radius(SOFT),
            "radius_hard": lambda: radius(0.0),
            "p0": lambda: np.asarray(jax.grad(endpoints)(jsc.segments.p0)),
        }[what]()
    return p["ref"][what]


@pytest.mark.parametrize("path", ["brute", "cluster"])
def test_soft_edge_render_matches_eager_reference(patch, path):
    sc = patch["scenes"][path]
    got = _port(patch, sc, SOFT).numpy()
    diff = np.abs(got - _reference(patch, "soft"))
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert (diff.max(-1) < 1e-4).mean() >= 0.99
    assert diff.mean() < 1e-5
    assert np.abs(got - _port(patch, sc, 0.0).numpy()).max() > 1e-3


@pytest.mark.parametrize("soft", [SOFT, 0.0])
@pytest.mark.parametrize("path", ["brute", "cluster"])
def test_radius_gradient_matches_jax_grad(patch, path, soft):
    sc = patch["scenes"][path]
    s = torch.tensor(1.0, requires_grad=True)
    segs = sc.segments._replace(r0=sc.segments.r0 * s,
                                r1=sc.segments.r1 * s)
    _port(patch, sc, soft, segs).mean().backward()
    want = _reference(patch, "radius_soft" if soft else "radius_hard")
    assert np.isfinite(float(s.grad)) and abs(want) > 1e-5
    np.testing.assert_allclose(float(s.grad), want, rtol=1e-3)


@pytest.mark.parametrize("path", ["brute", "cluster"])
def test_endpoint_gradient_matches_jax_grad(patch, path):
    sc = patch["scenes"][path]
    p0 = sc.segments.p0.clone().requires_grad_(True)
    img = _port(patch, sc, SOFT, sc.segments._replace(p0=p0))
    (torch.as_tensor(patch["w"]) * img).double().sum().backward()
    got = p0.grad.numpy()
    if path == "cluster":   # cluster order -> the scene's order
        sidx = sc.accel.seg_index.numpy()
        real = sidx >= 0
        back = np.zeros((int(sidx.max()) + 1, 3), np.float32)
        back[sidx[real]] = got[real]
        assert np.abs(got[~real]).max(initial=0.0) == 0.0
        got = back
    want = _reference(patch, "p0")
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 1e-3
    big = np.abs(want) > 1e-2 * scale
    assert big.sum() > 20
    np.testing.assert_allclose(got[big], want[big], rtol=1e-3)
    np.testing.assert_allclose(got[~big], want[~big], rtol=0,
                               atol=1e-5 * scale)
