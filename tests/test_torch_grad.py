"""Port vs reference: gradients with respect to the hair parameters.

(a) Each gradient gate (``_safe_sqrt``, ``_safe_asin``,
    ``_grad_interior``, ``safe_normalize``, the guarded atan2 in
    ``_angles``) gives a finite gradient equal to ``jax.grad``'s on its
    degenerate set (exactly 0) and off it (rtol 1e-5: ATen's and XLA's
    derivative formulas differ by ulps, measured 3e-6 for asin at
    -0.999).
(b) The gradient of the mean hair BSDF with respect to beta_m, beta_n and
    sigma_a, on ``tests/test_jax_hair.py``'s inputs, within rtol 1e-4 of
    ``jax.grad`` (measured 4e-5), and finite in its extreme case.
(c) The gradient of sum(W * image) for a fixed random W: the port
    through its cluster search (the plain kernels) against eager JAX by
    brute force, on the same uniforms, at 8x8. Russian roulette runs from
    bounce ``RR_START`` = 3, after that bounce's light is added, so a
    path needs a fifth bounce to feel it. Both packages' ``RR_START`` is
    set to 1 here and the render has depth 3: roulette scales or ends
    paths at the second bounce, as it would at the fourth, for the cost
    of three bounces. rtol 1e-3, measured 1.3e-5 (beta_m). Not detaching
    roulette's continuation probability moves the port's gradient by 8%
    (beta_n) to 92% (beta_m) here. Eager JAX's cost is mostly compiling
    each primitive once, so a smaller image saves little of it.
    ``tests/test_torch_grad_jit.py`` holds the jitted reference, at 12x12
    and depth 4.
(d) At depth 1 no sampled direction is ever traced, so the image is a
    smooth function of the parameters and the port's gradient equals a
    central finite difference of its own render (rtol 1e-3; measured
    4e-4 for beta_m, the difference's own truncation error at the
    narrow R and TT lobes, and 1e-5 for the others).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.bsdf import hair as jh
from yhair_tpu.core import safemath as jsafe
from yhair_tpu.core import scene as jscene
from yhair_tpu.integrator import path as jpath
from yhair_tpu_torch import convert
from yhair_tpu_torch.bsdf import hair as th
from yhair_tpu_torch.core import safemath as tsafe
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.ops import build_scene_clusters

torch.set_num_threads(1)

PARAMS = ("beta_m", "beta_n", "sigma_a")


def _angles_sum(mod):
    def f(w):
        return sum(x.sum() for x in mod._angles(w))
    return f


# (port function, reference function, input): the gradient of the sum of
# the output with respect to the input
GATES = {
    "safe_sqrt": (th._safe_sqrt, jh._safe_sqrt,
                  [0.0, -1e-3, 1e-12, 1e-13, 0.25]),
    "safe_asin": (th._safe_asin, jh._safe_asin,
                  [1.0, -1.0, 1.0 - 1e-7, 0.5, -0.999]),
    "grad_interior": (th._grad_interior, jh._grad_interior,
                      [0.9995, -0.9999, 1.0, 0.5, -0.3]),
    "safe_normalize": (tsafe.safe_normalize, jsafe.safe_normalize,
                       [[0.0, 0.0, 0.0], [1.0, 2.0, 2.0], [0.0, 1e-13, 0.0]]),
    "angles": (_angles_sum(th), _angles_sum(jh),
               [[0.5, 0.0, 0.0], [0.6, 0.48, 0.64], [1.0, 0.0, 0.0]]),
}


@pytest.mark.parametrize("name", sorted(GATES))
def test_gate_gradients_match_jax(name):
    fn_t, fn_j, x = GATES[name]
    x = np.asarray(x, np.float32)
    xt = torch.tensor(x, requires_grad=True)
    got, = torch.autograd.grad(fn_t(xt).sum(), xt)
    want = jax.grad(lambda v: fn_j(v).sum())(jnp.asarray(x))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=0)


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _mean_f_grads(h, wo, wi, beta_m, beta_n, sigma_a):
    """(port, reference) gradients of mean hair_f w.r.t. the params."""
    h, wo, wi = (np.asarray(a, np.float32) for a in (h, wo, wi))
    p = {"beta_m": beta_m, "beta_n": beta_n, "sigma_a": sigma_a}
    pt = convert.params_from_numpy(p, device="cpu")
    mt = th.HairMaterial.make(sigma_a=sigma_a)._replace(**pt)
    got = torch.autograd.grad(
        th.hair_f(mt, *map(torch.as_tensor, (h, wo, wi))).mean(),
        list(pt.values()))

    def mean_f(q):
        mat = jh.HairMaterial.make(sigma_a=sigma_a)._replace(**q)
        return jh.hair_f(mat, *map(jnp.asarray, (h, wo, wi))).mean()
    want = jax.jit(jax.grad(mean_f))({k: jnp.asarray(v, jnp.float32)
                                      for k, v in p.items()})
    return ({k: g.numpy() for k, g in zip(pt, got)},
            {k: np.asarray(want[k]) for k in pt})


def test_hair_f_gradients_match_jax():
    # tests/test_jax_hair.py::test_grad_beta_matches_fd's inputs
    rng = np.random.default_rng(4)
    h = rng.uniform(-0.98, 0.98, 512)
    wo, wi = _dirs(rng, 512), _dirs(rng, 512)
    got, want = _mean_f_grads(h, wo, wi, 0.3, 0.35, [0.2, 0.4, 0.8])
    for k in PARAMS:
        assert np.abs(want[k]).min() > 1e-3, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_hair_f_gradients_finite_at_extremes():
    # tests/test_jax_hair.py::test_extremes_finite_f32: h = +-1, grazing
    # directions, beta 0.05
    h = np.asarray([-1.0, 1.0, 0.0, 0.999])
    wo = np.tile([[0.999, 0.0447, 0.001]], (4, 1))
    wi = np.tile([[-0.999, 0.001, 0.0447]], (4, 1))
    wo = wo / np.linalg.norm(wo, axis=-1, keepdims=True)
    wi = wi / np.linalg.norm(wi, axis=-1, keepdims=True)
    got, want = _mean_f_grads(h, wo, wi, 0.05, 0.05, [0.1, 0.2, 0.3])
    for k in PARAMS:
        assert np.isfinite(got[k]).all() and np.isfinite(want[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def hairball():
    scene_d, cam_d = gen.curly_hairball(n_strands=300, n_seg=8)
    sc2, _ = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                  device="cpu")
    cam = tscene.camera_from_dict(cam_d, device="cpu")
    return scene_d, cam_d, sc2, cam


def _inputs(res, depth, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.random((res, res, 1, n_uniform_dims(depth))).astype(np.float32)
    w = rng.random((res, res, 3)).astype(np.float32)
    return u, w


def _port_image(sc2, cam, params, u, depth):
    sc = sc2._replace(hair=sc2.hair._replace(**params))
    return tpath.render(sc, cam, torch.as_tensor(u), max_depth=depth,
                        device="cpu")


def _port_loss(sc2, cam, params, u, w, depth):
    img = _port_image(sc2, cam, params, u, depth)
    return (torch.as_tensor(w) * img).double().sum()


def _true_params(scene_d):
    m = scene_d["hair_material"]
    return {k: np.asarray(m[k], np.float32) for k in PARAMS}


def test_render_gradients_match_eager_reference(hairball, monkeypatch):
    scene_d, cam_d, sc2, cam = hairball
    res, depth = 8, 3
    monkeypatch.setattr(tpath, "RR_START", 1)
    monkeypatch.setattr(jpath, "RR_START", 1)
    u, w = _inputs(res, depth)
    p0 = _true_params(scene_d)
    params = convert.params_from_numpy(p0, device="cpu")
    img = _port_image(sc2, cam, params, u, depth)
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
        assert np.isfinite(got).all() and np.abs(got).min() > 0.1, k
        np.testing.assert_allclose(got, np.asarray(want[k]), rtol=1e-3,
                                   err_msg=k)

    # Russian roulette acts on these paths
    monkeypatch.setattr(tpath, "RR_START", depth)
    with torch.no_grad():
        no_rr = _port_image(sc2, cam, params, u, depth)
    assert (no_rr - img.detach()).abs().max() > 1e-2


def test_depth1_gradients_match_finite_differences(hairball):
    scene_d, _, sc2, cam = hairball
    u, w = _inputs(12, 1, seed=1)
    p0 = _true_params(scene_d)
    params = convert.params_from_numpy(p0, device="cpu")
    _port_loss(sc2, cam, params, u, w, 1).backward()
    eps = 1e-3
    with torch.no_grad():
        for k in PARAMS:
            for c in np.ndindex(p0[k].shape):
                def at(delta):
                    q = {n: v.copy() for n, v in p0.items()}
                    q[k][c] += np.float32(delta)
                    loss = _port_loss(
                        sc2, cam, convert.params_from_numpy(q, device="cpu"),
                        u, w, 1)
                    return float(loss), float(q[k][c])
                (lp, xp), (lm, xm) = at(eps), at(-eps)
                fd = (lp - lm) / (xp - xm)
                got = float(params[k].grad[c])
                assert abs(fd) > 1e-2, (k, c)
                np.testing.assert_allclose(got, fd, rtol=1e-3,
                                           err_msg=f"{k}{c}")
