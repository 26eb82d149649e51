"""Environment-map lighting (``yhair_tpu/core/envmap.py``).

Equirectangular, y-up: u = atan2(d.z, d.x) / 2 pi + 0.5, v = acos(d.y) /
pi. Radiance is a bilinear lookup (wrap in u, clamp in v); sampling picks
a texel with one ``searchsorted`` over the flat luminance x sin(theta)
CDF and jitters within it; pdfs are in solid-angle measure. The scene
carries the tables (``env_tables``) as tensors; ``has_env`` is a shape
check, so it can branch in Python.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 6.283185307179586


def env_tables(image) -> dict:
    """(H, W, 3) radiance -> {image, pmf, cdf, sin_t} float64 numpy
    tables (the reference's ``EnvMap`` build, ``oracle/envmap.py``): the
    pmf of each texel is its luminance x sin(theta) over the sum
    (uniform when that is 0), the cdf its float64 cumulative sum."""
    image = np.asarray(image, np.float64)
    h = image.shape[0]
    lum = image.mean(-1)
    sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
    weights = (lum * sin_t[:, None]).reshape(-1)
    total = weights.sum()
    if total <= 0:
        weights = np.ones_like(weights)
        total = weights.sum()
    pmf = weights / total
    return {"image": image, "pmf": pmf, "cdf": np.cumsum(pmf),
            "sin_t": sin_t}


def has_env(scene) -> bool:
    return scene.env_map.shape[0] > 0


def _dims(scene):
    return scene.env_map.shape[0], scene.env_map.shape[1]


def _uv(d):
    u = torch.atan2(d[..., 2], d[..., 0]) / TWO_PI + 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def direction_to_texel(scene, d):
    """-> (x, y) int64 texel of each direction."""
    h, w = _dims(scene)
    u, v = _uv(d)
    x = torch.clamp((u % 1.0 * w).to(torch.int32), max=w - 1)
    y = torch.clamp((torch.clamp(v, 0.0, 1.0 - 1e-7) * h).to(torch.int32),
                    max=h - 1)
    return x.long(), y.long()


def env_eval(scene, d):
    """Bilinear radiance lookup (wrap u, clamp v). d (N, 3) -> (N, 3)."""
    h, w = _dims(scene)
    u, v = _uv(d)
    u = u % 1.0
    v = torch.clamp(v, 0.0, 1.0 - 1e-7)
    x = u * w - 0.5
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    # floor-mod, as jnp's % on int32: -1 % w == w - 1
    xi0 = (x0.to(torch.int32) % w).long()
    xi1 = (xi0 + 1) % w
    yi0 = y0.to(torch.int32).long()
    yi1 = torch.clamp(yi0 + 1, max=h - 1)
    em = scene.env_map
    c00, c01 = em[yi0, xi0], em[yi0, xi1]
    c10, c11 = em[yi1, xi0], em[yi1, xi1]
    return ((1 - fy) * ((1 - fx) * c00 + fx * c01)
            + fy * ((1 - fx) * c10 + fx * c11))


def _solid_angle(scene, y):
    h, w = _dims(scene)
    return (TWO_PI / w) * (math.pi / h) * torch.clamp(scene.env_sin[y],
                                                      min=1e-8)


def env_pdf(scene, d):
    """Solid-angle pdf of ``env_sample`` choosing direction d. -> (N,)."""
    w = _dims(scene)[1]
    x, y = direction_to_texel(scene, d)
    return scene.env_pmf[y * w + x] / _solid_angle(scene, y)


def env_sample(scene, u1, u2):
    """u1 picks the texel, u2 jitters in u. -> (direction (N, 3),
    pdf (N,))."""
    h, w = _dims(scene)
    idx = torch.searchsorted(scene.env_cdf,
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
    return d, scene.env_pmf[idx] / _solid_angle(scene, y)
