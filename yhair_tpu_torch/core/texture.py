"""Texture table and bilinear sampling (``yhair_tpu/core/texture.py``).

Every texture of a scene is flattened into one (P, 3) texel table plus a
(T, 3) int32 meta table (offset, H, W), so a batch of rays that reference
different textures is four flat gathers and a lerp.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_textures(textures, device="cpu"):
    """textures: list of (H, W, 3) arrays -> (tex_data (P, 3) float32,
    tex_meta (T, 3) int32). An empty list gives (0, 3) tables."""
    if not textures:
        return (torch.zeros((0, 3), device=device),
                torch.zeros((0, 3), dtype=torch.int32, device=device))
    datas, metas, off = [], [], 0
    for t in textures:
        a = np.asarray(t, np.float64)
        h, w = a.shape[0], a.shape[1]
        datas.append(a.reshape(h * w, 3))
        metas.append((off, h, w))
        off += h * w
    return (torch.as_tensor(np.concatenate(datas).astype(np.float32),
                            device=device),
            torch.as_tensor(np.asarray(metas, np.int32), device=device))


def sample_bilinear(tex_data, tex_meta, tid, u, v):
    """Per-ray texture fetch: tid (N,) int32 (-1 = none, which gives 1.0,
    a neutral factor); u, v (N,). Wrap u, clamp v. -> (N, 3)."""
    meta = tex_meta[torch.clamp(tid, min=0).long()]          # (N, 3)
    off, h, w = meta[:, 0], meta[:, 1], meta[:, 2]
    hf, wf = h.to(u.dtype), w.to(u.dtype)
    x = u * wf - 0.5
    y = torch.minimum(torch.clamp(v * hf - 0.5, min=0.0), hf - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    # floor-mod of int32 tensors, as jnp's %: -1 % w == w - 1
    xi0 = x0.to(torch.int32) % w
    xi1 = (xi0 + 1) % w
    yi0 = y0.to(torch.int32)
    yi1 = torch.minimum(yi0 + 1, h - 1)

    def texel(yi, xi):
        return tex_data[(off + yi * w + xi).long()]
    val = ((1 - fy) * ((1 - fx) * texel(yi0, xi0) + fx * texel(yi0, xi1))
           + fy * ((1 - fx) * texel(yi1, xi0) + fx * texel(yi1, xi1)))
    return torch.where((tid >= 0)[:, None], val, 1.0)


def apply_textures(tex_data, tex_meta, sp, uv):
    """A gathered per-hit SurfaceMaterial with its textures multiplied in
    (color, emission, and roughness by the texel's mean)."""
    u, v = uv[:, 0], uv[:, 1]
    color = sp.color * sample_bilinear(tex_data, tex_meta, sp.color_tex,
                                       u, v)
    emission = sp.emission * sample_bilinear(tex_data, tex_meta,
                                             sp.emission_tex, u, v)
    rtex = sample_bilinear(tex_data, tex_meta, sp.roughness_tex, u, v)
    return sp._replace(color=color, emission=emission,
                       roughness=sp.roughness * rtex.mean(-1))
