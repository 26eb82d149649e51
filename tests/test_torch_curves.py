"""Port vs reference: first-class cubic Bezier curves.

After ``tests/test_bezier.py`` and ``tests/test_curves.py``, on curves
and rays made with numpy from a seed, against eager JAX
(``jax.disable_jit()``), 256 rays throughout:
- ``tessellate``: chords and radii bit-equal (the same float32
  parameters, the same operation order);
- ``nearest_hit``: hit mask, curve and t bit-equal, u to 1e-6 (measured
  equal);
- d t / d cp of one hit, through the integrator's form (a detached
  search, the chord re-evaluated from the control points), against
  ``jax.grad`` of the reference's search: rtol 1e-4;
- the curve scene's render (the curve branch of the integrator: the
  chord re-evaluated from the control points, the curve's shadows)
  against the reference's: max |diff| < 1e-4 on >= 99% of the pixels
  and mean |diff| < 1e-5 (measured max 3e-8); against the same curves
  tessellated into segments, the reference's gate (>= 99.5% within
  1e-2, mean < 2e-3; measured max 1.5e-8);
- curves cast shadows on the plane;
- the gradient of sum(W * image) with respect to the control points,
  with soft silhouettes, against ``jax.grad``: rtol 1e-3 on the
  entries above 1% of the largest (measured 3.4e-6), atol 1e-5 of it
  elsewhere (measured 8.2e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle.geometry import bezier_to_segments
from yhair_tpu.core import scene as jscene
from yhair_tpu.geometry import bezier as jb
from yhair_tpu.integrator import path as jpath
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.geometry import bezier as tb
from yhair_tpu_torch.geometry import segments as tseg
from yhair_tpu_torch.integrator import path as tpath

torch.set_num_threads(1)

RES, SPP, DEPTH = 16, 1, 2
N_RAYS = RES * RES * SPP
SOFT = 0.3
CAM = {"position": np.array([0.0, 0.0, 2.2]), "look_at": np.zeros(3),
       "up": np.array([0.0, 1.0, 0.0]), "vfov_deg": 35.0}


def _curves(n, seed=0):
    """``tests/test_curves.py:_curves``."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 1, 3)) * 0.1
    cp = base + np.cumsum(rng.normal(size=(n, 4, 3)) * 0.15, axis=1)
    cp -= cp.mean(axis=(0, 1))
    return cp, np.full(n, 0.03), np.full(n, 0.015)


def _scene(curves=None, segments=None):
    """``tests/test_curves.py:_scene``: a plane, a light, the curves."""
    sc = {"hair_material": {"sigma_a": np.array([0.06, 0.1, 0.2]),
                            "beta_m": 0.3, "beta_n": 0.35},
          "planes": [{"point": [0, 0, -1.0], "normal": [0, 0, 1.0],
                      "albedo": [0.4, 0.35, 0.3]}],
          "point_lights": [{"position": [1.5, 1.5, 2.5],
                            "intensity": [14.0, 14.0, 14.0]}],
          "environment": np.array([0.02, 0.02, 0.03])}
    if curves is not None:
        sc["curves"] = dict(zip(("cp", "r0", "r1"), curves))
    if segments is not None:
        sc["segments"] = segments
    return sc


def _tessellated(cp, r0, r1):
    parts = [bezier_to_segments(cp[i], r0[i], r1[i],
                                n_seg=1 << tpath.CURVE_DEPTH)
             for i in range(cp.shape[0])]
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(4))


def _rays(seed, cp):
    """Rays aimed at jittered points of the curves."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(N_RAYS, 3)) * 1.5
    ci = rng.integers(0, cp.shape[0], N_RAYS)
    ts = rng.random(N_RAYS)[:, None]
    c = cp[ci]
    tgt = ((1 - ts) ** 3 * c[:, 0] + 3 * (1 - ts) ** 2 * ts * c[:, 1]
           + 3 * (1 - ts) * ts ** 2 * c[:, 2] + ts ** 3 * c[:, 3]
           + rng.normal(size=(N_RAYS, 3)) * 0.01)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _f32(*arrays):
    return [np.asarray(a, np.float32) for a in arrays]


def test_tessellate_is_bit_equal():
    cp, r0, r1 = _f32(*_curves(5, seed=1))
    with jax.disable_jit():
        want = jb.tessellate(jnp.asarray(cp), jnp.asarray(r0),
                             jnp.asarray(r1), depth=3)
    got = tb.tessellate(*map(torch.as_tensor, (cp, r0, r1)), depth=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_nearest_hit_matches_eager_reference():
    cp, r0, r1 = _curves(5, seed=1)
    o, d = _rays(2, cp)
    cp, r0, r1 = _f32(cp, r0, r1)
    with jax.disable_jit():
        want = [np.asarray(a) for a in jb.nearest_hit(
            *map(jnp.asarray, (o, d, cp, r0, r1)), depth=3)]
    got = [a.numpy() for a in tb.nearest_hit(
        *map(torch.as_tensor, (o, d, cp, r0, r1)), depth=3)]
    t_g, c_g, u_g, h_g = got
    t_w, c_w, u_w, h_w = want
    assert h_w.sum() > N_RAYS // 4
    np.testing.assert_array_equal(h_g, h_w)
    np.testing.assert_array_equal(t_g, t_w)
    np.testing.assert_array_equal(c_g[h_w], c_w[h_w])
    np.testing.assert_allclose(u_g[h_w], u_w[h_w], rtol=0, atol=1e-6)


def test_dt_dcp_matches_jax_grad():
    cp, r0, r1 = _curves(5, seed=1)
    o, d = _rays(3, cp)
    cp, r0, r1 = _f32(cp, r0, r1)
    _, _, _, hit = tb.nearest_hit(*map(torch.as_tensor, (o, d, cp, r0, r1)))
    ri = int(np.flatnonzero(hit.numpy())[0])
    cpt = torch.tensor(cp, requires_grad=True)

    def t_port(c):
        # the integrator's form: a detached search, then the winning
        # chord re-evaluated from the control points
        o1, d1 = torch.as_tensor(o[ri:ri + 1]), torch.as_tensor(d[ri:ri + 1])
        _, ci, u, _ = tb.nearest_hit(o1, d1, c.detach(),
                                     *map(torch.as_tensor, (r0, r1)))
        n_leaf = 1 << tpath.CURVE_DEPTH
        leaf = torch.clamp((u * n_leaf).to(torch.int32), 0, n_leaf - 1)
        q0 = tb.bezier_point(c[ci], leaf.float() / n_leaf)
        q1 = tb.bezier_point(c[ci], (leaf + 1).float() / n_leaf)
        return tseg._closest_approach(o1, d1, q0, q1)[0][0]
    got, = torch.autograd.grad(t_port(cpt), cpt)

    def t_ref(c):
        return jb.nearest_hit(jnp.asarray(o[ri:ri + 1]),
                              jnp.asarray(d[ri:ri + 1]), c, jnp.asarray(r0),
                              jnp.asarray(r1))[0][0]
    with jax.disable_jit():
        want = np.asarray(jax.grad(t_ref)(jnp.asarray(cp)))
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


def _uniforms(seed):
    return np.random.default_rng(seed).random(
        (RES, RES, SPP, n_uniform_dims(DEPTH))).astype(np.float32)


def _port_render(scene_d, u, **kw):
    return tpath.render(tscene.from_dict(scene_d, device="cpu"),
                        tscene.camera_from_dict(CAM, device="cpu"),
                        torch.as_tensor(u), max_depth=DEPTH, device="cpu",
                        **kw)


def _ref_render(scene_d, u, **kw):
    return jpath.render(jscene.from_dict(scene_d),
                        jscene.camera_from_dict(CAM), jnp.asarray(u),
                        max_depth=DEPTH, chunk=512, **kw)


def test_curve_render_matches_reference_and_tessellation():
    crv = _curves(3)
    u = _uniforms(5)
    got = _port_render(_scene(curves=crv), u).numpy()
    with jax.disable_jit():
        want = np.asarray(_ref_render(_scene(curves=crv), u))
    diff = np.abs(got - want)
    assert (diff.max(-1) < 1e-4).mean() >= 0.99
    assert diff.mean() < 1e-5
    # the curve shows, and the tessellated strands render alike
    bare = _port_render(_scene(), u).numpy()
    assert np.abs(got - bare).max() > 0.05
    tes = _port_render(_scene(segments=_tessellated(*crv)), u).numpy()
    diff = np.abs(got - tes).max(-1)
    assert (diff < 1e-2).mean() > 0.995 and diff.mean() < 2e-3


def test_curves_cast_shadows():
    cp, r0, r1 = _curves(3)
    cp = cp * 0.5 + np.array([0.4, 0.4, 0.7])   # between light and plane
    u = _uniforms(6)
    img = _port_render(_scene(curves=(cp, r0 * 3, r1 * 3)), u).numpy()
    img0 = _port_render(_scene(), u).numpy()
    assert (img.mean(-1) < img0.mean(-1) - 5e-3).any()


def test_render_gradient_wrt_control_points_matches_jax_grad():
    cp, r0, r1 = _curves(2, seed=3)
    scene_d = _scene(curves=(cp, r0 * 1.6, r1 * 1.6))
    u = _uniforms(7)
    w = np.random.default_rng(8).random((RES, RES, 3)).astype(np.float32)
    sc = tscene.from_dict(scene_d, device="cpu")
    cpt = sc.crv_cp.clone().requires_grad_(True)
    img = tpath.render(sc._replace(crv_cp=cpt),
                       tscene.camera_from_dict(CAM, device="cpu"),
                       torch.as_tensor(u), max_depth=DEPTH,
                       edge_softness=SOFT, device="cpu")
    (torch.as_tensor(w) * img).double().sum().backward()
    got = cpt.grad.numpy()

    jsc = jscene.from_dict(scene_d)
    jcam = jscene.camera_from_dict(CAM)

    def loss(c):
        return (jnp.asarray(w) * jpath.render(
            jsc._replace(crv_cp=c), jcam, jnp.asarray(u), max_depth=DEPTH,
            chunk=512, edge_softness=SOFT)).sum()
    with jax.disable_jit():
        want = np.asarray(jax.grad(loss)(jsc.crv_cp))
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 1e-2
    big = np.abs(want) > 1e-2 * scale
    np.testing.assert_allclose(got[big], want[big], rtol=1e-3)
    np.testing.assert_allclose(got[~big], want[~big], rtol=0,
                               atol=1e-5 * scale)
