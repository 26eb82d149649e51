"""Port vs reference: hair and surface BSDFs on the same inputs.

Transcendentals (exp, log, atan2, asin, sigmoid, ...) differ by ulps
between XLA and ATen. So at least 97% of values agree to rtol 1e-5
(atol 1e-6), and all to rtol 1e-3: a peaked lobe (GGX at roughness 0.15,
hair at beta_m 0.08, variance ~4e-3) multiplies an input's ulp by up to
~1/variance, measured up to 8e-4 relative. A sampled direction inherits
those ulps, so directions are held to 1e-5 absolute, and the sample's f
and pdf to the reference's BSDF evaluated at the port's direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import surface_bsdf as osb
from yhair_tpu.bsdf import hair as jh
from yhair_tpu.bsdf import surface as js
from yhair_tpu_torch.bsdf import hair as th
from yhair_tpu_torch.bsdf import surface as ts

torch.set_num_threads(1)


def _close(got, want, mask=None):
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    assert np.isclose(got, want, rtol=1e-5, atol=1e-6).mean() >= 0.97
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)

HAIRS = {"brown": dict(sigma_a=(0.2, 0.4, 0.8), beta_m=0.3, beta_n=0.35),
         "rough_dark": dict(sigma_a=(1.2, 1.6, 2.4), beta_m=0.6,
                            beta_n=0.7, alpha=0.05),
         "smooth_blond": dict(sigma_a=(0.06, 0.1, 0.2), beta_m=0.08,
                              beta_n=0.15)}


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _hair_inputs(seed, n=4096):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.98, 0.98, n).astype(np.float32), _dirs(rng, n),
            _dirs(rng, n), rng.random((n, 4)).astype(np.float32))


def _mats(kw):
    kw = dict(kw, sigma_a=np.asarray(kw["sigma_a"]))
    return jh.HairMaterial.make(**kw), th.HairMaterial.make(**kw)


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("name", sorted(HAIRS))
def test_hair_f_pdf_match(name):
    mj, mt = _mats(HAIRS[name])
    h, wo, wi, _ = _hair_inputs(0)
    cj = jh.hair_ctx(mj, jnp.asarray(h), jnp.asarray(wo))
    ct = th.hair_ctx(mt, *_t(h, wo))
    wi_t, = _t(wi)
    fj, pj = jh.hair_f_pdf_ctx(cj, jnp.asarray(wi))
    ft, pt = th.hair_f_pdf_ctx(ct, wi_t)
    pairs = [(ft, fj), (pt, pj),
             (th.hair_f_ctx(ct, wi_t), jh.hair_f_ctx(cj, jnp.asarray(wi))),
             (th.hair_pdf_ctx(ct, wi_t), jh.hair_pdf_ctx(cj, jnp.asarray(wi))),
             (th.hair_f(mt, *_t(h, wo, wi)),
              jh.hair_f(mj, *map(jnp.asarray, (h, wo, wi)))),
             (th.hair_pdf(mt, *_t(h, wo, wi)),
              jh.hair_pdf(mj, *map(jnp.asarray, (h, wo, wi))))]
    for got, want in pairs:
        _close(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(HAIRS))
def test_hair_sample_match(name):
    mj, mt = _mats(HAIRS[name])
    h, wo, _, u = _hair_inputs(1)
    wi_j, _, _ = jh.hair_sample(mj, *map(jnp.asarray, (h, wo, u)))
    wi_t, f_t, pdf_t = th.hair_sample(mt, *_t(h, wo, u))
    # the lobe pick flips only where u0 sits within ulps of a cdf edge
    same = np.abs(wi_t.numpy() - np.asarray(wi_j)).max(-1) < 1e-5
    assert same.mean() >= 0.999
    cj = jh.hair_ctx(mj, jnp.asarray(h), jnp.asarray(wo))
    fj, pj = jh.hair_f_pdf_ctx(cj, jnp.asarray(wi_t.numpy()))
    _close(f_t.numpy(), fj)
    _close(pdf_t.numpy(), pj)


def test_hair_furnace():
    """White furnace on the port (tests/test_jax_hair.py:test_furnace_jax):
    with no absorption the sampled weight f |cos| / pdf averages 1."""
    rng = np.random.default_rng(3)
    n = 30_000
    h = torch.as_tensor(rng.uniform(-1, 1, n), dtype=torch.float32)
    wo = torch.as_tensor(_dirs(rng, n))
    u = torch.as_tensor(rng.random((n, 4)), dtype=torch.float32)
    mat = th.HairMaterial.make(sigma_a=np.zeros(3), beta_m=0.4, beta_n=0.4)
    wi, f, pdf = th.hair_sample(mat, h, wo, u)
    w = (f[:, 0] * torch.abs(wi[:, 2]) / torch.clamp(pdf, min=1e-12)).numpy()
    ok = pdf.numpy() > 1e-9
    assert abs(w[ok].mean() - 1.0) < 0.01


SURFACES = {
    "matte": dict(color=(0.7, 0.5, 0.3), roughness=1.0, specular=0.0),
    "glossy": dict(color=(0.6, 0.2, 0.2), roughness=0.2, ior=1.5),
    "rough_metal": dict(color=(0.9, 0.7, 0.4), roughness=0.3, metallic=1.0),
    "thin_glass_rough": dict(color=(0.9, 0.9, 0.9), roughness=0.15,
                             transmission=1.0),
    "mirror": dict(color=(0.9, 0.9, 0.9), roughness=0.0, metallic=1.0),
    "thin_glass": dict(color=(1.0, 1.0, 1.0), roughness=0.0,
                       transmission=1.0),
}


def _surface_inputs(name, seed, n=4096):
    rng = np.random.default_rng(seed)
    mats = [osb.make_material(**SURFACES[name])]
    idx = np.zeros(n, np.int32)
    pj = js.SurfaceMaterial.make(mats).gather(jnp.asarray(idx))
    pt = ts.SurfaceMaterial.make(mats).gather(torch.as_tensor(idx))
    z = rng.uniform(0.05, 1.0, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(1 - z ** 2)
    wo = np.stack([s * np.cos(phi), s * np.sin(phi), z], -1)
    return (pj, pt, wo.astype(np.float32), _dirs(rng, n),
            rng.random((n, 3)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_surface_f_pdf_match(name):
    pj, pt, wo, wi, _ = _surface_inputs(name, 5)
    _close(ts.surface_f(pt, *_t(wo, wi)).numpy(),
           js.surface_f(pj, jnp.asarray(wo), jnp.asarray(wi)))
    _close(ts.surface_pdf(pt, *_t(wo, wi)).numpy(),
           js.surface_pdf(pj, jnp.asarray(wo), jnp.asarray(wi)))


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_surface_sample_match(name):
    pj, pt, wo, _, u = _surface_inputs(name, 6)
    wi_j, w_j, _, dl_j = js.surface_sample(pj, jnp.asarray(wo),
                                           jnp.asarray(u))
    wi_t, w_t, pdf_t, dl_t = ts.surface_sample(pt, *_t(wo, u))
    same = np.abs(wi_t.numpy() - np.asarray(wi_j)).max(-1) < 1e-5
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(dl_t.numpy()[same], np.asarray(dl_j)[same])
    wi_p = jnp.asarray(wi_t.numpy())
    _close(pdf_t.numpy(), js.surface_pdf(pj, jnp.asarray(wo), wi_p))
    # the weight is f |cos| / pdf at the sampled direction, or the delta
    # lobe's constant
    _close(w_t.numpy(), w_j, mask=same)


def test_sigma_a_helpers_match():
    """Melanin and reflectance remaps: products, sums, log and powers."""
    rng = np.random.default_rng(12)
    ce, cp = rng.uniform(0, 8, 64), rng.uniform(0, 2, 64)
    _close(th.sigma_a_from_concentration(ce, cp).numpy(),
           jh.sigma_a_from_concentration(ce.astype(np.float32),
                                         cp.astype(np.float32)))
    color = rng.uniform(0.01, 0.99, (64, 3)).astype(np.float32)
    beta_n = rng.uniform(0.1, 0.9, 64).astype(np.float32)
    _close(th.sigma_a_from_reflectance(color, beta_n).numpy(),
           jh.sigma_a_from_reflectance(jnp.asarray(color),
                                       jnp.asarray(beta_n)))
