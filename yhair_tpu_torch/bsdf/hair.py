"""pbrt-v3 hair scattering model: eval / sample / pdf
(``yhair_tpu/bsdf/hair.py``).

Differentiable with respect to sigma_a, beta_m, beta_n and alpha. Square
roots, arcsines, the strand offset h and atan2 go through the
reference's gradient gates (``_safe_sqrt``, ``_safe_asin``,
``_grad_interior``, the guarded atan2 in ``_angles``): the values are
the plain forms' bit for bit, and the gradient is zero and finite where
the plain form's derivative is infinite.

Convention (pbrt's): local frame x = strand tangent, sin(theta) = w.x,
phi = atan2(w.z, w.y); ``f`` carries a 1/|wi.z| factor which the
integrator cancels with its |cos| term.

A bounce's hair work (the context, f and pdf at each next-event
direction, the BSDF sample) is ``hair_bounce``, the torch code, or on
gradient-free passes on the card ``hair_bounce_kernel``: one launch of
``csrc/hair.cu:hair_kernel``, bit-equal to it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069
TWO_PI = 6.283185307179586
PI = math.pi


class HairMaterial(NamedTuple):
    """sigma_a (3,), beta_m, beta_n, alpha (scale tilt, radians), eta."""

    sigma_a: torch.Tensor
    beta_m: torch.Tensor
    beta_n: torch.Tensor
    alpha: torch.Tensor
    eta: torch.Tensor

    @classmethod
    def make(cls, sigma_a, beta_m=0.3, beta_n=0.3, alpha=0.0349066,
             eta=1.55, device="cpu"):
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        return cls(t(sigma_a), t(beta_m), t(beta_n), t(alpha), t(eta))

    def to(self, device):
        return HairMaterial(*(a.to(device) for a in self))


# ---------------------------------------------------------------------------
# scalar helpers (shape-preserving, f32-safe)


def _safe_sqrt(x):
    """sqrt(max(x, 0)); the gradient is 0 where x <= 1e-12 (sqrt'(0) is
    infinite)."""
    return torch.where(x > 1e-12, torch.sqrt(torch.clamp(x, min=1e-12)),
                       torch.sqrt(torch.clamp(x, min=0.0)).detach())


def _safe_asin(x):
    """arcsin(clip(x, -1, 1)); the gradient is 0 in the outermost 1e-6
    band (asin'(1) is infinite)."""
    lim = 1.0 - 1e-6
    return torch.where((x > -lim) & (x < lim),
                       torch.asin(torch.clamp(x, -lim, lim)),
                       torch.asin(torch.clamp(x, -1.0, 1.0)).detach())


def _grad_interior(x, lim=1.0 - 1e-3):
    """Identity in value; the gradient is 0 where |x| >= lim, the
    strand's outermost edge, where asin(h) and sqrt(1 - h^2) have
    infinite derivatives."""
    xc = torch.clamp(x, -lim, lim)
    return xc + (x - xc).detach()


def _i0(x):
    """Modified Bessel I0, 10-term even series (pbrt's I0)."""
    x2 = x * x
    val = torch.ones_like(x)
    term = torch.ones_like(x)
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        val = val + term
    return val


def _log_i0(x):
    xs = torch.clamp(x, min=1e-30)
    big = x + 0.5 * (-math.log(TWO_PI) + torch.log(1.0 / xs)
                     + 1.0 / (8.0 * xs))
    small = torch.log(_i0(torch.clamp(x, max=12.0)))
    return torch.where(x > 12.0, big, small)


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return torch.sigmoid(x / s)


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    denom = torch.clamp(u * k + _logistic_cdf(a, s), min=1e-30)
    x = -s * torch.log(1.0 / denom - 1.0)
    return torch.clamp(x, a, b)


def fr_dielectric(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel (external eta_i = 1)."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = cos_theta_i > 0
    one = torch.ones_like(cos_theta_i)
    eta = eta * one
    eta_i = torch.where(entering, one, eta)
    eta_t = torch.where(entering, eta, one)
    ci = torch.abs(cos_theta_i)
    sin_t = eta_i / eta_t * _safe_sqrt(1.0 - ci * ci)
    ct = _safe_sqrt(1.0 - sin_t * sin_t)
    r_parl = (eta_t * ci - eta_i * ct) / torch.clamp(
        eta_t * ci + eta_i * ct, min=1e-30)
    r_perp = (eta_i * ci - eta_t * ct) / torch.clamp(
        eta_i * ci + eta_t * ct, min=1e-30)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(sin_t >= 1.0, torch.ones_like(fr), fr)


# ---------------------------------------------------------------------------
# parameter remaps


def roughness_to_v(beta_m):
    """-> tuple of 4 per-lobe longitudinal variances."""
    v0 = (0.726 * beta_m + 0.812 * beta_m ** 2 + 3.7 * beta_m ** 20) ** 2
    return (v0, 0.25 * v0, 4.0 * v0, 4.0 * v0)


def roughness_to_s(beta_n):
    return SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n ** 2
                             + 5.372 * beta_n ** 22)


def alpha_terms(alpha):
    """sin/cos of 2^k alpha, k = 0..2 (double-angle recurrence)."""
    s0, c0 = torch.sin(alpha), torch.cos(alpha)
    s1, c1 = 2.0 * c0 * s0, c0 * c0 - s0 * s0
    s2, c2 = 2.0 * c1 * s1, c1 * c1 - s1 * s1
    return (s0, s1, s2), (c0, c1, c2)


# absorption per unit concentration of eumelanin and pheomelanin (pbrt-v3
# HairBSDF::SigmaAFromConcentration; Chiang et al. 2016)
EUMELANIN = (0.419, 0.697, 1.37)
PHEOMELANIN = (0.187, 0.4, 1.05)
# (device, dtype) -> the two constant vectors there, made once: a copy
# from the host to the card would synchronize it on every call
_MELANIN = {}


def sigma_a_from_concentration(ce, cp):
    """Melanin concentrations (..., ) -> absorption (..., 3). Floats and
    arrays become float32; tensors keep their device, dtype and autograd
    graph, and the constants follow them."""
    like = ce if isinstance(ce, torch.Tensor) else cp
    dev, dt = torch.device("cpu"), torch.float32
    if isinstance(like, torch.Tensor):
        dev = like.device
        if like.is_floating_point():
            dt = like.dtype
    ce = torch.as_tensor(ce, dtype=dt, device=dev)
    cp = torch.as_tensor(cp, dtype=dt, device=dev)
    if (dev, dt) not in _MELANIN:
        _MELANIN[dev, dt] = (torch.tensor(EUMELANIN, dtype=dt, device=dev),
                             torch.tensor(PHEOMELANIN, dtype=dt, device=dev))
    eumelanin, pheomelanin = _MELANIN[dev, dt]
    return ce[..., None] * eumelanin + cp[..., None] * pheomelanin


def sigma_a_from_reflectance(color, beta_n):
    beta_n = torch.as_tensor(beta_n, dtype=torch.float32)[..., None]
    denom = (5.969 - 0.215 * beta_n + 2.532 * beta_n ** 2
             - 10.73 * beta_n ** 3 + 5.574 * beta_n ** 4
             + 0.245 * beta_n ** 5)
    color = torch.as_tensor(color, dtype=torch.float32)
    return (torch.log(torch.clamp(color, 1e-9, 1.0)) / denom) ** 2


# ---------------------------------------------------------------------------
# lobe terms


def _mp(cos_i, cos_o, sin_i, sin_o, v):
    v = torch.clamp(v, min=1e-7)
    a = cos_i * cos_o / v
    b = sin_i * sin_o / v
    exp_small = torch.clamp(_log_i0(a) - b - 1.0 / v + 0.6931
                            + torch.log(1.0 / (2.0 * v)), -80.0, 80.0)
    out_small = torch.exp(exp_small)
    a_big = torch.clamp(a, 0.0, 12.0)
    b_big = torch.clamp(b, -60.0, 60.0)
    inv_v = torch.clamp(1.0 / v, max=20.0)
    sinh_term = 0.5 * (torch.exp(inv_v) - torch.exp(-inv_v))
    out_big = torch.exp(-b_big) * _i0(a_big) / (sinh_term * 2.0 * v)
    return torch.where(v <= 0.1, out_small, out_big)


def _phi_fn(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * PI


def _np_term(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_fn(p, gamma_o, gamma_t)
    dphi = torch.remainder(dphi + PI, TWO_PI) - PI
    return _trimmed_logistic(dphi, s, -PI, PI)


def _tilted(sin_o, cos_o, s2k, c2k, p):
    """Scale-tilted (sin, |cos|) of theta_o for lobe p (pbrt ordering)."""
    if p == 0:
        s = sin_o * c2k[1] - cos_o * s2k[1]
        c = cos_o * c2k[1] + sin_o * s2k[1]
    elif p == 1:
        s = sin_o * c2k[0] + cos_o * s2k[0]
        c = cos_o * c2k[0] - sin_o * s2k[0]
    elif p == 2:
        s = sin_o * c2k[2] + cos_o * s2k[2]
        c = cos_o * c2k[2] - sin_o * s2k[2]
    else:
        s, c = sin_o, cos_o
    return s, torch.abs(c)


def _shared_terms(mat: HairMaterial, h, sin_o, cos_o):
    """Refraction geometry + per-lobe attenuation; shared by f/pdf/sample."""
    eta = mat.eta
    sin_t = sin_o / eta
    cos_t = _safe_sqrt(1.0 - sin_t * sin_t)
    etap = _safe_sqrt(eta * eta - sin_o * sin_o) / torch.clamp(cos_o,
                                                               min=1e-7)
    sin_gt = h / torch.clamp(etap, min=1e-7)
    cos_gt = _safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = _safe_asin(sin_gt)
    T = torch.exp(-mat.sigma_a * (2.0 * cos_gt
                                  / torch.clamp(cos_t, min=1e-7))[..., None])
    cos_go = _safe_sqrt(1.0 - h * h)
    f = fr_dielectric(cos_o * cos_go, eta)[..., None]
    ap0 = f.expand(f.shape[:-1] + (3,))
    ap1 = (1.0 - f) ** 2 * T
    ap2 = ap1 * T * f
    ap3 = ap2 * f * T / torch.clamp(1.0 - T * f, min=1e-5)
    return gamma_t, T, (ap0, ap1, ap2, ap3)


def _angles(w):
    sin_t = w[..., 0]
    cos_t = _safe_sqrt(1.0 - sin_t * sin_t)
    y, z = w[..., 1], w[..., 2]
    # the reference's guarded atan2: atan2(0, 1) == atan2(0, 0) == 0, so
    # the substitution keeps every value, and atan2's gradient, NaN at
    # (0, 0), is zero there (miss lanes have a zero shading frame)
    safe = (y * y + z * z) > 1e-18
    phi = torch.atan2(torch.where(safe, z, torch.zeros_like(z)),
                      torch.where(safe, y, torch.ones_like(y)))
    return sin_t, cos_t, phi


def _ap_pdf(aps):
    ys = [torch.clamp(a.mean(-1), min=0.0) for a in aps]
    total = torch.clamp(ys[0] + ys[1] + ys[2] + ys[3], min=1e-30)
    return [y / total for y in ys]


# ---------------------------------------------------------------------------
# shared evaluation context: everything that depends only on (material,
# h, wo), computed once per shading point and reused by every wi


class HairCtx(NamedTuple):
    gamma_o: torch.Tensor
    sin_o: torch.Tensor
    cos_o: torch.Tensor
    phi_o: torch.Tensor
    gamma_t: torch.Tensor
    s: torch.Tensor              # azimuthal logistic scale
    vs: tuple                    # 4 per-lobe longitudinal variances
    tilt: tuple                  # 4 (sin_op, cos_op) tilted angles
    aps: tuple                   # 4 attenuation terms (..., 3)
    ap_pdf: tuple                # 4 lobe-selection probabilities


def hair_ctx(mat: HairMaterial, h, wo) -> HairCtx:
    """Precompute the wi-independent part of the BSDF at a shading point."""
    h = _grad_interior(h)
    gamma_o = _safe_asin(h)
    sin_o, cos_o, phi_o = _angles(wo)
    gamma_t, _T, aps = _shared_terms(mat, h, sin_o, cos_o)
    s = roughness_to_s(mat.beta_n)
    vs = roughness_to_v(mat.beta_m)
    s2k, c2k = alpha_terms(mat.alpha)
    tilt = tuple(_tilted(sin_o, cos_o, s2k, c2k, p)
                 for p in range(P_MAX + 1))
    return HairCtx(gamma_o=gamma_o, sin_o=sin_o, cos_o=cos_o, phi_o=phi_o,
                   gamma_t=gamma_t, s=s, vs=vs, tilt=tilt, aps=aps,
                   ap_pdf=tuple(_ap_pdf(aps)))


def _lobe_mn(ctx: HairCtx, wi):
    """Per-lobe longitudinal x azimuthal products for one wi:
    ([m_p * n_p for p < P_MAX], m_last)."""
    sin_i, cos_i, phi_i = _angles(wi)
    phi = phi_i - ctx.phi_o
    mn = []
    for p in range(P_MAX):
        sin_op, cos_op = ctx.tilt[p]
        m = _mp(cos_i, cos_op, sin_i, sin_op, ctx.vs[p])
        n = _np_term(phi, float(p), ctx.s, ctx.gamma_o, ctx.gamma_t)
        mn.append(m * n)
    m_last = _mp(cos_i, ctx.cos_o, sin_i, ctx.sin_o, ctx.vs[P_MAX])
    return mn, m_last


def _f_from_mn(ctx, mn, m_last, wi):
    fsum = (m_last / TWO_PI)[..., None] * ctx.aps[P_MAX]
    for p in range(P_MAX):
        fsum = fsum + mn[p][..., None] * ctx.aps[p]
    abs_cos = torch.abs(wi[..., 2])
    return fsum / torch.clamp(abs_cos, min=1e-7)[..., None]


def _pdf_from_mn(ctx, mn, m_last):
    pdf = m_last * ctx.ap_pdf[P_MAX] / TWO_PI
    for p in range(P_MAX):
        pdf = pdf + mn[p] * ctx.ap_pdf[p]
    return pdf


def hair_f_ctx(ctx: HairCtx, wi):
    """BSDF value from a precomputed context. -> (..., 3)."""
    mn, m_last = _lobe_mn(ctx, wi)
    return _f_from_mn(ctx, mn, m_last, wi)


def hair_pdf_ctx(ctx: HairCtx, wi):
    mn, m_last = _lobe_mn(ctx, wi)
    return _pdf_from_mn(ctx, mn, m_last)


def hair_f_pdf_ctx(ctx: HairCtx, wi):
    """Fused (f, pdf): one _lobe_mn pass for both."""
    mn, m_last = _lobe_mn(ctx, wi)
    return _f_from_mn(ctx, mn, m_last, wi), _pdf_from_mn(ctx, mn, m_last)


def hair_sample_wi(ctx: HairCtx, u):
    """Sample a direction from a context; u (..., 4)."""
    ap_pdf = ctx.ap_pdf
    u0 = u[..., 0]
    cdf0 = ap_pdf[0]
    cdf1 = cdf0 + ap_pdf[1]
    cdf2 = cdf1 + ap_pdf[2]
    p_idx = ((u0 >= cdf0).to(torch.int32) + (u0 >= cdf1).to(torch.int32)
             + (u0 >= cdf2).to(torch.int32))

    sin_op = torch.zeros_like(ctx.sin_o)
    cos_op = torch.zeros_like(ctx.cos_o)
    v_p = torch.zeros_like(ctx.sin_o)
    for p in range(P_MAX + 1):
        s_p, c_p = ctx.tilt[p]
        sel = p_idx == p
        sin_op = torch.where(sel, s_p, sin_op)
        cos_op = torch.where(sel, c_p, cos_op)
        v_p = torch.where(sel, ctx.vs[p], v_p)

    # longitudinal sample
    u1 = torch.clamp(u[..., 1], min=1e-5)
    cos_theta = 1.0 + v_p * torch.log(u1 + (1.0 - u1) * torch.exp(-2.0 / v_p))
    sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
    cos_phi = torch.cos(TWO_PI * u[..., 2])
    sin_i = -cos_theta * sin_op + sin_theta * cos_phi * cos_op
    cos_i = _safe_sqrt(1.0 - sin_i * sin_i)

    # azimuthal sample
    p_f = p_idx.to(cos_i.dtype)
    dphi_l = (_phi_fn(p_f, ctx.gamma_o, ctx.gamma_t)
              + _sample_trimmed_logistic(u[..., 3], ctx.s, -PI, PI))
    dphi = torch.where(p_idx < P_MAX, dphi_l, TWO_PI * u[..., 3])
    phi_i = ctx.phi_o + dphi
    return torch.stack([sin_i, cos_i * torch.cos(phi_i),
                        cos_i * torch.sin(phi_i)], dim=-1)


# ---------------------------------------------------------------------------
# public interface (thin wrappers over the context API)


def hair_f(mat: HairMaterial, h, wo, wi):
    """BSDF value (pbrt convention — includes 1/|wi.z|). -> (..., 3)."""
    return hair_f_ctx(hair_ctx(mat, h, wo), wi)


def hair_pdf(mat: HairMaterial, h, wo, wi):
    """Solid-angle pdf of ``hair_sample``. -> (...)."""
    return hair_pdf_ctx(hair_ctx(mat, h, wo), wi)


def hair_sample(mat: HairMaterial, h, wo, u):
    """Sample wi given 4 uniforms u (..., 4). -> (wi, f, pdf)."""
    ctx = hair_ctx(mat, h, wo)
    wi = hair_sample_wi(ctx, u)
    f, pdf = hair_f_pdf_ctx(ctx, wi)
    return wi, f, pdf


# ---------------------------------------------------------------------------
# one bounce's hair work: the torch code, and its CUDA kernel

# a material row of the kernel's table: sigma_a (3), beta_m, beta_n,
# alpha, eta
MAT_COLS = 7


def material_at(mat: HairMaterial, mat_id):
    """Each lane's hair material: the rows of mat_id (N,) of a per-shape
    table (M-row leaves); one material's 0-dim leaves broadcast as they
    are."""
    if mat.beta_m.ndim == 0:
        return mat
    mat_id = mat_id.long()
    return type(mat)(*(a[mat_id] for a in mat))


def hair_bounce(mat: HairMaterial, h, wo, wis, u, n_f=0):
    """One bounce's hair BSDF at each lane: the context of (mat, h, wo);
    f towards each local direction of ``wis`` and the pdf there, but at
    the first ``n_f`` (None); a direction drawn from u (..., 4), and f
    and the pdf there. The plain twin of ``hair_bounce_kernel`` (the
    torch code, which autograd differentiates). -> (fs, pdfs, wi_h, f_h,
    pdf_h), wi_h and pdf_h detached."""
    ctx = hair_ctx(mat, h, wo)
    fs, pdfs = [], []
    for j, wi in enumerate(wis):
        if j < n_f:
            fs.append(hair_f_ctx(ctx, wi))
            pdfs.append(None)
        else:
            f, pdf = hair_f_pdf_ctx(ctx, wi)
            fs.append(f)
            pdfs.append(pdf)
    wi_h = hair_sample_wi(ctx, u).detach()
    f_h, pdf_h = hair_f_pdf_ctx(ctx, wi_h)
    return fs, pdfs, wi_h, f_h, pdf_h.detach()


def material_table(mat: HairMaterial):
    """(M, MAT_COLS) rows of sigma_a, beta_m, beta_n, alpha, eta: one row
    for one material (0-dim leaves), one a shape for a per-shape table."""
    return torch.cat([mat.sigma_a.reshape(-1, 3),
                      *(x.reshape(-1, 1) for x in mat[1:])], 1)


def hair_bounce_kernel(mat: HairMaterial, mat_id, h, wo, wis, u):
    """``hair_bounce`` of lanes on the card, f and pdf at every direction,
    in one ``hair_kernel`` launch; nothing is differentiated. mat: one
    material, or a per-shape table read at mat_id (N,) int32 (the two
    cases of ``material_at``). h (N,), wo (N, 3) and each of wis (N, 3)
    float32; u (N, 4), its rows may be strided. ValueError unless the
    inputs fit. -> (fs, pdfs, wi_h, f_h, pdf_h), fs and pdfs views of
    one (N, K, 3) and one (N, K) tensor."""
    n, k, f32 = h.shape[0], len(wis), torch.float32
    table = material_table(mat)
    mat_id = None if mat.beta_m.ndim == 0 else mat_id
    kernels.check_tensors(
        h.device, (h, f32, (n,)), (wo, f32, (n, 3)),
        (table, f32, (table.shape[0], MAT_COLS)),
        (mat_id, torch.int32, (n,)), *((w, f32, (n, 3)) for w in wis),
        (u, f32, (n, 4), True))
    wi = torch.stack(wis, 1) if k else None
    f = torch.empty((n, k, 3), dtype=f32, device=h.device)
    pdf = torch.empty((n, k), dtype=f32, device=h.device)
    wi_h, f_h = (torch.empty((n, 3), dtype=f32, device=h.device)
                 for _ in range(2))
    pdf_h = torch.empty(n, dtype=f32, device=h.device)
    kernels.launch("yhair_hair_shade", h, wo, table, mat_id, wi, k, u,
                   u.stride(0), n, f if k else None, pdf if k else None,
                   wi_h, f_h, pdf_h)
    return list(f.unbind(1)), list(pdf.unbind(1)), wi_h, f_h, pdf_h
