"""Surface (non-hair) BSDF (``yhair_tpu/bsdf/surface.py``).

Diffuse + GGX specular/metal + thin transmission + delta (roughness == 0)
variants, evaluated branch-free so one pass shades a mixed batch. Local
frame with n = +z, wo.z > 0; ``f`` excludes the |cos| factor; delta lobes
return f = 0 / pdf = 0 and contribute only through ``surface_sample``'s
weight.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.safemath import safe_normalize

LUM = (0.2126, 0.7152, 0.0722)
MIN_ALPHA = 1e-4
DELTA_ROUGHNESS = 1e-3


class SurfaceMaterial(NamedTuple):
    """SoA material table (M entries), or per-hit rows after ``gather``."""

    emission: torch.Tensor      # (M, 3)
    color: torch.Tensor         # (M, 3)
    roughness: torch.Tensor     # (M,)
    metallic: torch.Tensor      # (M,)
    ior: torch.Tensor           # (M,)
    transmission: torch.Tensor  # (M,)
    specular: torch.Tensor      # (M,) dielectric-lobe scale (matte = 0)
    color_tex: torch.Tensor     # (M,) int32 scene texture id, -1 = none
    emission_tex: torch.Tensor  # (M,) int32
    roughness_tex: torch.Tensor  # (M,) int32

    @classmethod
    def make(cls, mats: list, device="cpu") -> "SurfaceMaterial":
        """From a list of oracle-format material dicts (>= 1 entry)."""
        if not mats:
            mats = [{"emission": (0, 0, 0), "color": (0, 0, 0),
                     "roughness": 1.0, "metallic": 0.0, "ior": 1.5,
                     "transmission": 0.0, "specular": 1.0}]

        def col(key, default, width=None):
            rows = [np.asarray(m.get(key, default), np.float64)
                    for m in mats]
            a = (np.stack([np.broadcast_to(r, (width,)) for r in rows])
                 if width else np.asarray(rows))
            return torch.as_tensor(a.astype(np.float32), device=device)

        def icol(key):
            return torch.as_tensor([int(m.get(key, -1)) for m in mats],
                                   dtype=torch.int32, device=device)

        return cls(
            emission=col("emission", (0.0, 0.0, 0.0), 3),
            color=col("color", (0.0, 0.0, 0.0), 3),
            roughness=col("roughness", 1.0),
            metallic=col("metallic", 0.0),
            ior=col("ior", 1.5),
            transmission=col("transmission", 0.0),
            specular=col("specular", 1.0),
            color_tex=icol("color_tex"),
            emission_tex=icol("emission_tex"),
            roughness_tex=icol("roughness_tex"),
        )

    def gather(self, idx) -> "SurfaceMaterial":
        """Per-hit parameter lookup: (M, ...) -> (N, ...)."""
        idx = torch.clamp(idx, 0, self.roughness.shape[0] - 1).long()
        return SurfaceMaterial(*(a[idx] for a in self))

    def to(self, device):
        return SurfaceMaterial(*(a.to(device) for a in self))


def _lum(c):
    return c[..., 0] * LUM[0] + c[..., 1] * LUM[1] + c[..., 2] * LUM[2]


def _f0(p: SurfaceMaterial):
    f0d = p.specular * ((p.ior - 1.0) / (p.ior + 1.0)) ** 2
    return f0d[..., None] * (1.0 - p.metallic[..., None]) \
        + p.color * p.metallic[..., None]


def _fresnel(p: SurfaceMaterial, cos_t):
    """Mixed Schlick fresnel; the dielectric lobe (with its grazing term)
    is scaled by ``specular``."""
    m = torch.clamp(1.0 - torch.abs(cos_t), 0.0, 1.0) ** 5
    f_metal = p.color + (1.0 - p.color) * m[..., None]
    f0d = ((p.ior - 1.0) / (p.ior + 1.0)) ** 2
    f_diel = (p.specular * (f0d + (1.0 - f0d) * m))[..., None]
    return p.metallic[..., None] * f_metal \
        + (1.0 - p.metallic[..., None]) * f_diel


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


def _ggx_g(cos_o, cos_i, alpha):
    return _ggx_g1(cos_o, alpha) * _ggx_g1(cos_i, alpha)


def _ggx_sample_vndf(wo, alpha, u0, u1):
    """Heitz 2018 visible-normal GGX sampling (isotropic). wo.z > 0."""
    vh = torch.stack([alpha * wo[:, 0], alpha * wo[:, 1], wo[:, 2]], -1)
    vh = safe_normalize(vh)
    lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
    inv = torch.rsqrt(torch.clamp(lensq, min=1e-24))
    t1 = torch.where((lensq > 1e-20)[:, None],
                     torch.stack([-vh[:, 1] * inv, vh[:, 0] * inv,
                                  torch.zeros_like(inv)], -1),
                     vh.new_tensor([[1.0, 0.0, 0.0]]))
    t2 = torch.linalg.cross(vh, t1)
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
    """pdf of wi = reflect(wo, h) under VNDF sampling:
    G1(wo) D(h) / 4 cos_o."""
    cos_o = torch.clamp(wo[:, 2], min=1e-6)
    return _ggx_g1(cos_o, alpha) * _ggx_d(hv[:, 2], alpha) / (4.0 * cos_o)


def _lobe_weights(p: SurfaceMaterial, cos_o):
    fo = _lum(_fresnel(p, cos_o))
    w_spec = fo
    base = (1.0 - fo) * (1.0 - p.metallic)
    w_diff = base * (1.0 - p.transmission)
    w_trans = base * p.transmission
    total = w_diff + w_spec + w_trans
    safe = torch.clamp(total, min=1e-12)
    ok = total > 1e-12
    one, zero = torch.ones_like(total), torch.zeros_like(total)
    return (torch.where(ok, w_diff / safe, one),
            torch.where(ok, w_spec / safe, zero),
            torch.where(ok, w_trans / safe, zero))


def _flip_z(w):
    return w * w.new_tensor([1.0, 1.0, -1.0])


def surface_f(p: SurfaceMaterial, wo, wi):
    """BSDF value (N, 3) WITHOUT |cos wi|; p holds per-hit (N, ...) rows."""
    delta = p.roughness < DELTA_ROUGHNESS
    alpha = torch.clamp(p.roughness ** 2, min=MIN_ALPHA)
    cos_o = torch.clamp(wo[:, 2], min=1e-6)
    cos_i = wi[:, 2]
    f0 = _f0(p)

    wi_r = torch.where((cos_i < 0)[:, None], _flip_z(wi), wi)
    hv = safe_normalize(wo + wi_r)
    ch = (wo * hv).sum(-1)
    fh = _fresnel(p, ch)
    d_term = _ggx_d(hv[:, 2], alpha)
    g_term = _ggx_g(cos_o, torch.abs(cos_i), alpha)
    micro = (d_term * g_term
             / torch.clamp(4.0 * cos_o * torch.abs(cos_i), min=1e-12))[:, None]
    spec = fh * micro

    # Ashikhmin-Shirley coupled diffuse
    kd = ((1.0 - p.metallic) * (1.0 - p.transmission)
          * (1.0 - _lum(f0)))[:, None]
    as_o = 1.0 - (1.0 - 0.5 * cos_o) ** 5
    as_i = 1.0 - (1.0 - 0.5 * torch.abs(cos_i)) ** 5
    diff = p.color * (28.0 / (23.0 * math.pi)) * kd \
        * (as_o * as_i)[:, None]
    f_refl = diff + spec

    kt = ((1.0 - p.metallic) * p.transmission)[:, None] \
        * (1.0 - _lum(fh))[:, None]
    f_trans = p.color * kt * micro

    zero = torch.zeros_like(f_refl)
    f = torch.where((cos_i > 0)[:, None], f_refl, f_trans)
    f = torch.where((torch.abs(cos_i) < 1e-7)[:, None], zero, f)
    f_delta = torch.where((cos_i > 0)[:, None], diff, zero)
    return torch.where(delta[:, None], f_delta, f)


def surface_pdf(p: SurfaceMaterial, wo, wi):
    delta = p.roughness < DELTA_ROUGHNESS
    alpha = torch.clamp(p.roughness ** 2, min=MIN_ALPHA)
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


def surface_sample(p: SurfaceMaterial, wo, u):
    """u[:, 0:3] = (u0, u1, u_lobe) ->
    (wi, weight = f|cos|/pdf incl. delta, pdf, is_delta_sample)."""
    delta = p.roughness < DELTA_ROUGHNESS
    alpha = torch.clamp(p.roughness ** 2, min=MIN_ALPHA)
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
    kt = ((1.0 - p.metallic) * p.transmission)[:, None]
    w_delta_trans = p.color * kt * (1.0 - _lum(fh))[:, None] \
        / torch.clamp(w_trans[:, None], min=1e-12)
    is_delta_sample = delta & (pick_spec | pick_trans)
    weight = torch.where((delta & pick_spec)[:, None], w_delta_spec, weight)
    weight = torch.where((delta & pick_trans)[:, None], w_delta_trans,
                         weight)

    bad = (pick_spec & ~delta & (wi[:, 2] <= 0)) \
        | (pick_trans & ~delta & (wi[:, 2] >= 0))
    weight = torch.where(bad[:, None], torch.zeros_like(weight), weight)
    return wi, weight, pdf, is_delta_sample
