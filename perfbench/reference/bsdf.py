"""Scattering of the plain reference: the pbrt-v3 hair model (R, TT, TRT
and the residual lobe), the surface model (Ashikhmin-Shirley diffuse,
GGX specular and transmission, delta lobes) and the equirectangular
environment map, in plain torch with the arithmetic the program states
(``yhair_tpu_torch/bsdf/hair.py``, ``bsdf/surface.py``,
``core/envmap.py`` at the commit that froze this copy), including the
gradient gates that keep derivatives finite at the strand's edge.

A hair material is a dict of tensors (sigma_a (3,), beta_m, beta_n,
alpha, eta); a surface material a dict of per-hit rows.
"""

from __future__ import annotations

import math

import torch

P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069
TWO_PI = 6.283185307179586
PI = math.pi
LUM = (0.2126, 0.7152, 0.0722)
MIN_ALPHA = 1e-4
DELTA_ROUGHNESS = 1e-3


def cross(a, b):
    """torch.linalg.cross, written out for types it does not take."""
    if a.dtype in (torch.float32, torch.float64):
        return torch.linalg.cross(a, b)
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def safe_normalize(v, eps=1e-12):
    n2 = (v * v).sum(-1, keepdim=True)
    safe = n2 > eps * eps
    n = torch.sqrt(torch.where(safe, n2, torch.ones_like(n2)))
    return torch.where(safe, v / n, v.detach() * (1.0 / eps))


# ---------------------------------------------------------------------------
# hair


def _safe_sqrt(x):
    return torch.where(x > 1e-12, torch.sqrt(torch.clamp(x, min=1e-12)),
                       torch.sqrt(torch.clamp(x, min=0.0)).detach())


def _safe_asin(x):
    lim = 1.0 - 1e-6
    return torch.where((x > -lim) & (x < lim),
                       torch.asin(torch.clamp(x, -lim, lim)),
                       torch.asin(torch.clamp(x, -1.0, 1.0)).detach())


def _grad_interior(x, lim=1.0 - 1e-3):
    xc = torch.clamp(x, -lim, lim)
    return xc + (x - xc).detach()


def _i0(x):
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


def _fr_dielectric(cos_theta_i, eta):
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


def _angles(w):
    sin_t = w[..., 0]
    cos_t = _safe_sqrt(1.0 - sin_t * sin_t)
    y, z = w[..., 1], w[..., 2]
    safe = (y * y + z * z) > 1e-18
    phi = torch.atan2(torch.where(safe, z, torch.zeros_like(z)),
                      torch.where(safe, y, torch.ones_like(y)))
    return sin_t, cos_t, phi


def hair_ctx(mat, h, wo):
    """The wi-independent part of the hair BSDF at each shading point."""
    h = _grad_interior(h)
    gamma_o = _safe_asin(h)
    sin_o, cos_o, phi_o = _angles(wo)
    eta = mat["eta"]
    sin_t = sin_o / eta
    cos_t = _safe_sqrt(1.0 - sin_t * sin_t)
    etap = _safe_sqrt(eta * eta - sin_o * sin_o) / torch.clamp(cos_o,
                                                               min=1e-7)
    sin_gt = h / torch.clamp(etap, min=1e-7)
    cos_gt = _safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = _safe_asin(sin_gt)
    T = torch.exp(-mat["sigma_a"]
                  * (2.0 * cos_gt / torch.clamp(cos_t, min=1e-7))[..., None])
    cos_go = _safe_sqrt(1.0 - h * h)
    f = _fr_dielectric(cos_o * cos_go, eta)[..., None]
    ap0 = f.expand(f.shape[:-1] + (3,))
    ap1 = (1.0 - f) ** 2 * T
    ap2 = ap1 * T * f
    ap3 = ap2 * f * T / torch.clamp(1.0 - T * f, min=1e-5)
    aps = (ap0, ap1, ap2, ap3)
    bm, bn = mat["beta_m"], mat["beta_n"]
    v0 = (0.726 * bm + 0.812 * bm ** 2 + 3.7 * bm ** 20) ** 2
    vs = (v0, 0.25 * v0, 4.0 * v0, 4.0 * v0)
    s = SQRT_PI_OVER_8 * (0.265 * bn + 1.194 * bn ** 2 + 5.372 * bn ** 22)
    alpha = mat["alpha"]
    s0, c0 = torch.sin(alpha), torch.cos(alpha)
    s1, c1 = 2.0 * c0 * s0, c0 * c0 - s0 * s0
    s2, c2 = 2.0 * c1 * s1, c1 * c1 - s1 * s1
    tilt = tuple(_tilted(sin_o, cos_o, (s0, s1, s2), (c0, c1, c2), p)
                 for p in range(P_MAX + 1))
    ys = [torch.clamp(a.mean(-1), min=0.0) for a in aps]
    total = torch.clamp(ys[0] + ys[1] + ys[2] + ys[3], min=1e-30)
    return {"gamma_o": gamma_o, "sin_o": sin_o, "cos_o": cos_o,
            "phi_o": phi_o, "gamma_t": gamma_t, "s": s, "vs": vs,
            "tilt": tilt, "aps": aps, "ap_pdf": [y / total for y in ys]}


def _lobe_mn(ctx, wi):
    sin_i, cos_i, phi_i = _angles(wi)
    phi = phi_i - ctx["phi_o"]
    mn = []
    for p in range(P_MAX):
        sin_op, cos_op = ctx["tilt"][p]
        m = _mp(cos_i, cos_op, sin_i, sin_op, ctx["vs"][p])
        n = _np_term(phi, float(p), ctx["s"], ctx["gamma_o"], ctx["gamma_t"])
        mn.append(m * n)
    m_last = _mp(cos_i, ctx["cos_o"], sin_i, ctx["sin_o"], ctx["vs"][P_MAX])
    return mn, m_last


def hair_f(ctx, wi):
    """BSDF value with pbrt's 1/|wi.z| factor. -> (N, 3)."""
    mn, m_last = _lobe_mn(ctx, wi)
    fsum = (m_last / TWO_PI)[..., None] * ctx["aps"][P_MAX]
    for p in range(P_MAX):
        fsum = fsum + mn[p][..., None] * ctx["aps"][p]
    return fsum / torch.clamp(torch.abs(wi[..., 2]), min=1e-7)[..., None]


def hair_f_pdf(ctx, wi):
    mn, m_last = _lobe_mn(ctx, wi)
    fsum = (m_last / TWO_PI)[..., None] * ctx["aps"][P_MAX]
    for p in range(P_MAX):
        fsum = fsum + mn[p][..., None] * ctx["aps"][p]
    f = fsum / torch.clamp(torch.abs(wi[..., 2]), min=1e-7)[..., None]
    pdf = m_last * ctx["ap_pdf"][P_MAX] / TWO_PI
    for p in range(P_MAX):
        pdf = pdf + mn[p] * ctx["ap_pdf"][p]
    return f, pdf


def hair_sample_wi(ctx, u):
    ap_pdf = ctx["ap_pdf"]
    u0 = u[..., 0]
    cdf0 = ap_pdf[0]
    cdf1 = cdf0 + ap_pdf[1]
    cdf2 = cdf1 + ap_pdf[2]
    p_idx = ((u0 >= cdf0).to(torch.int32) + (u0 >= cdf1).to(torch.int32)
             + (u0 >= cdf2).to(torch.int32))
    sin_op = torch.zeros_like(ctx["sin_o"])
    cos_op = torch.zeros_like(ctx["cos_o"])
    v_p = torch.zeros_like(ctx["sin_o"])
    for p in range(P_MAX + 1):
        s_p, c_p = ctx["tilt"][p]
        sel = p_idx == p
        sin_op = torch.where(sel, s_p, sin_op)
        cos_op = torch.where(sel, c_p, cos_op)
        v_p = torch.where(sel, ctx["vs"][p], v_p)
    u1 = torch.clamp(u[..., 1], min=1e-5)
    cos_theta = 1.0 + v_p * torch.log(u1 + (1.0 - u1) * torch.exp(-2.0 / v_p))
    sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
    cos_phi = torch.cos(TWO_PI * u[..., 2])
    sin_i = -cos_theta * sin_op + sin_theta * cos_phi * cos_op
    cos_i = _safe_sqrt(1.0 - sin_i * sin_i)
    p_f = p_idx.to(cos_i.dtype)
    dphi_l = (_phi_fn(p_f, ctx["gamma_o"], ctx["gamma_t"])
              + _sample_trimmed_logistic(u[..., 3], ctx["s"], -PI, PI))
    dphi = torch.where(p_idx < P_MAX, dphi_l, TWO_PI * u[..., 3])
    phi_i = ctx["phi_o"] + dphi
    return torch.stack([sin_i, cos_i * torch.cos(phi_i),
                        cos_i * torch.sin(phi_i)], dim=-1)


# ---------------------------------------------------------------------------
# surfaces


def _lum(c):
    return c[..., 0] * LUM[0] + c[..., 1] * LUM[1] + c[..., 2] * LUM[2]


def _f0(p):
    f0d = p["specular"] * ((p["ior"] - 1.0) / (p["ior"] + 1.0)) ** 2
    return f0d[..., None] * (1.0 - p["metallic"][..., None]) \
        + p["color"] * p["metallic"][..., None]


def _fresnel(p, cos_t):
    m = torch.clamp(1.0 - torch.abs(cos_t), 0.0, 1.0) ** 5
    f_metal = p["color"] + (1.0 - p["color"]) * m[..., None]
    f0d = ((p["ior"] - 1.0) / (p["ior"] + 1.0)) ** 2
    f_diel = (p["specular"] * (f0d + (1.0 - f0d) * m))[..., None]
    return p["metallic"][..., None] * f_metal \
        + (1.0 - p["metallic"][..., None]) * f_diel


def _ggx_d(cos_h, alpha):
    a2 = alpha ** 2
    den = cos_h ** 2 * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * den ** 2, min=1e-30)
    return torch.where(cos_h > 0, d, torch.zeros_like(d))


def _ggx_g1(cos_w, alpha):
    a2 = alpha ** 2
    c = torch.abs(cos_w)
    return 2.0 * c / torch.clamp(c + torch.sqrt(a2 + (1.0 - a2) * c ** 2),
                                 min=1e-12)


def _ggx_sample_vndf(wo, alpha, u0, u1):
    vh = torch.stack([alpha * wo[:, 0], alpha * wo[:, 1], wo[:, 2]], -1)
    vh = safe_normalize(vh)
    lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
    inv = torch.rsqrt(torch.clamp(lensq, min=1e-24))
    t1 = torch.where((lensq > 1e-20)[:, None],
                     torch.stack([-vh[:, 1] * inv, vh[:, 0] * inv,
                                  torch.zeros_like(inv)], -1),
                     vh.new_tensor([[1.0, 0.0, 0.0]]))
    t2 = cross(vh, t1)
    r = torch.sqrt(u0)
    phi = 2.0 * math.pi * u1
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 ** 2, min=0.0)) + s * p2
    nh = p1[:, None] * t1 + p2[:, None] * t2 + torch.sqrt(torch.clamp(
        1.0 - p1 ** 2 - p2 ** 2, min=0.0))[:, None] * vh
    h = torch.stack([alpha * nh[:, 0], alpha * nh[:, 1],
                     torch.clamp(nh[:, 2], min=0.0)], -1)
    return safe_normalize(h)


def _ggx_pdf_wi(wo, hv, alpha):
    cos_o = torch.clamp(wo[:, 2], min=1e-6)
    return _ggx_g1(cos_o, alpha) * _ggx_d(hv[:, 2], alpha) / (4.0 * cos_o)


def _lobe_weights(p, cos_o):
    fo = _lum(_fresnel(p, cos_o))
    base = (1.0 - fo) * (1.0 - p["metallic"])
    w_diff = base * (1.0 - p["transmission"])
    w_trans = base * p["transmission"]
    total = w_diff + fo + w_trans
    safe = torch.clamp(total, min=1e-12)
    ok = total > 1e-12
    one, zero = torch.ones_like(total), torch.zeros_like(total)
    return (torch.where(ok, w_diff / safe, one),
            torch.where(ok, fo / safe, zero),
            torch.where(ok, w_trans / safe, zero))


def _flip_z(w):
    return w * w.new_tensor([1.0, 1.0, -1.0])


def surface_f(p, wo, wi):
    """BSDF value without |cos wi|. -> (N, 3)."""
    delta = p["roughness"] < DELTA_ROUGHNESS
    alpha = torch.clamp(p["roughness"] ** 2, min=MIN_ALPHA)
    cos_o = torch.clamp(wo[:, 2], min=1e-6)
    cos_i = wi[:, 2]
    f0 = _f0(p)
    wi_r = torch.where((cos_i < 0)[:, None], _flip_z(wi), wi)
    hv = safe_normalize(wo + wi_r)
    ch = (wo * hv).sum(-1)
    fh = _fresnel(p, ch)
    d_term = _ggx_d(hv[:, 2], alpha)
    g_term = _ggx_g1(cos_o, alpha) * _ggx_g1(torch.abs(cos_i), alpha)
    micro = (d_term * g_term
             / torch.clamp(4.0 * cos_o * torch.abs(cos_i), min=1e-12))[:, None]
    spec = fh * micro
    kd = ((1.0 - p["metallic"]) * (1.0 - p["transmission"])
          * (1.0 - _lum(f0)))[:, None]
    as_o = 1.0 - (1.0 - 0.5 * cos_o) ** 5
    as_i = 1.0 - (1.0 - 0.5 * torch.abs(cos_i)) ** 5
    diff = p["color"] * (28.0 / (23.0 * math.pi)) * kd \
        * (as_o * as_i)[:, None]
    f_refl = diff + spec
    kt = ((1.0 - p["metallic"]) * p["transmission"])[:, None] \
        * (1.0 - _lum(fh))[:, None]
    f_trans = p["color"] * kt * micro
    zero = torch.zeros_like(f_refl)
    f = torch.where((cos_i > 0)[:, None], f_refl, f_trans)
    f = torch.where((torch.abs(cos_i) < 1e-7)[:, None], zero, f)
    f_delta = torch.where((cos_i > 0)[:, None], diff, zero)
    return torch.where(delta[:, None], f_delta, f)


def surface_pdf(p, wo, wi):
    delta = p["roughness"] < DELTA_ROUGHNESS
    alpha = torch.clamp(p["roughness"] ** 2, min=MIN_ALPHA)
    cos_i = wi[:, 2]
    w_diff, w_spec, w_trans = _lobe_weights(
        p, torch.clamp(wo[:, 2], min=1e-6))
    pdf_diff = torch.clamp(cos_i, min=0.0) / math.pi
    wi_r = torch.where((cos_i < 0)[:, None], _flip_z(wi), wi)
    hv = safe_normalize(wo + wi_r)
    pdf_ggx = _ggx_pdf_wi(wo, hv, alpha)
    pdf = torch.where(cos_i > 0, w_diff * pdf_diff + w_spec * pdf_ggx,
                      w_trans * pdf_ggx)
    return torch.where(delta, w_diff * pdf_diff, pdf)


def surface_sample(p, wo, u):
    """-> (wi, weight f |cos| / pdf, pdf, is_delta_sample)."""
    delta = p["roughness"] < DELTA_ROUGHNESS
    alpha = torch.clamp(p["roughness"] ** 2, min=MIN_ALPHA)
    cos_o = torch.clamp(wo[:, 2], min=1e-6)
    w_diff, w_spec, w_trans = _lobe_weights(p, cos_o)
    u0, u1, ul = u[:, 0], u[:, 1], u[:, 2]
    pick_diff = ul < w_diff
    pick_spec = ~pick_diff & (ul < w_diff + w_spec)
    pick_trans = ~pick_diff & ~pick_spec
    r = torch.sqrt(u0)
    phi = 2.0 * math.pi * u1
    wi_d = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u0, min=0.0))], -1)
    hv = _ggx_sample_vndf(wo, alpha, u0, u1)
    wi_s = 2.0 * (wo * hv).sum(-1)[:, None] * hv - wo
    wi_mirror = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    wi_s = torch.where(delta[:, None], wi_mirror, wi_s)
    wi_t = _flip_z(wi_s)
    wi_t = torch.where(delta[:, None], -wo, wi_t)
    wi = torch.where(pick_diff[:, None], wi_d,
                     torch.where(pick_spec[:, None], wi_s, wi_t))
    pdf = surface_pdf(p, wo, wi)
    f = surface_f(p, wo, wi)
    weight = f * torch.abs(wi[:, 2:3]) / torch.clamp(pdf[:, None], min=1e-12)
    weight = torch.where((pdf > 1e-12)[:, None], weight,
                         torch.zeros_like(weight))
    fh = _fresnel(p, cos_o)
    w_delta_spec = fh / torch.clamp(w_spec[:, None], min=1e-12)
    kt = ((1.0 - p["metallic"]) * p["transmission"])[:, None]
    w_delta_trans = p["color"] * kt * (1.0 - _lum(fh))[:, None] \
        / torch.clamp(w_trans[:, None], min=1e-12)
    is_delta_sample = delta & (pick_spec | pick_trans)
    weight = torch.where((delta & pick_spec)[:, None], w_delta_spec, weight)
    weight = torch.where((delta & pick_trans)[:, None], w_delta_trans,
                         weight)
    bad = (pick_spec & ~delta & (wi[:, 2] <= 0)) \
        | (pick_trans & ~delta & (wi[:, 2] >= 0))
    weight = torch.where(bad[:, None], torch.zeros_like(weight), weight)
    return wi, weight, pdf, is_delta_sample


# ---------------------------------------------------------------------------
# environment map (y up: u = atan2(d.z, d.x) / 2 pi + 0.5, v = acos(d.y) / pi)


def _uv(d):
    u = torch.atan2(d[..., 2], d[..., 0]) / TWO_PI + 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def env_eval(sc, d):
    """Bilinear radiance: wrap in u, clamp in v."""
    h, w = sc.env_map.shape[0], sc.env_map.shape[1]
    u, v = _uv(d)
    u = u % 1.0
    v = torch.clamp(v, 0.0, 1.0 - 1e-7)
    x = u * w - 0.5
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = (x0.to(torch.int32) % w).long()
    xi1 = (xi0 + 1) % w
    yi0 = y0.to(torch.int32).long()
    yi1 = torch.clamp(yi0 + 1, max=h - 1)
    em = sc.env_map
    c00, c01 = em[yi0, xi0], em[yi0, xi1]
    c10, c11 = em[yi1, xi0], em[yi1, xi1]
    return ((1 - fy) * ((1 - fx) * c00 + fx * c01)
            + fy * ((1 - fx) * c10 + fx * c11))


def _solid_angle(sc, y):
    h, w = sc.env_map.shape[0], sc.env_map.shape[1]
    return (TWO_PI / w) * (math.pi / h) * torch.clamp(sc.env_sin[y], min=1e-8)


def env_pdf(sc, d):
    h, w = sc.env_map.shape[0], sc.env_map.shape[1]
    u, v = _uv(d)
    x = torch.clamp((u % 1.0 * w).to(torch.int32), max=w - 1).long()
    y = torch.clamp((torch.clamp(v, 0.0, 1.0 - 1e-7) * h).to(torch.int32),
                    max=h - 1).long()
    return sc.env_pmf[y * w + x] / _solid_angle(sc, y)


def env_sample(sc, u1, u2):
    h, w = sc.env_map.shape[0], sc.env_map.shape[1]
    idx = torch.searchsorted(sc.env_cdf,
                             torch.clamp(u1, 0.0, 1.0 - 1e-7).contiguous())
    idx = torch.clamp(idx, max=h * w - 1)
    y, x = idx // w, idx % w
    uu = (x.to(u2.dtype) + torch.clamp(u2, 0.0, 1.0 - 1e-7)) / w
    vv = (y.to(u2.dtype) + 0.5) / h
    theta = vv * math.pi
    phi = (uu - 0.5) * TWO_PI
    st = torch.sin(theta)
    d = torch.stack([st * torch.cos(phi), torch.cos(theta),
                     st * torch.sin(phi)], -1)
    return d, sc.env_pmf[idx] / _solid_angle(sc, y)
