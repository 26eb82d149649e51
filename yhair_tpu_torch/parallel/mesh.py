"""Counter-hash uniforms and the tile pixel order
(``yhair_tpu/parallel/mesh.py``).

The reference shards the ray batch over a device mesh; this slice runs
on one card, so only the parts the render path needs are here: the
screen-tile pixel permutation and the per-(pixel, sample, dim) hash that
makes a render reproducible whatever the batching.

torch has no unsigned 32-bit shift or add on every device, so the hash is
done in int64 and cut back to 32 bits after every operation; the result
is bit-equal to the reference's uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rng import n_uniform_dims

TILE_W, TILE_H = 16, 8
_M32 = 0xFFFFFFFF


def tile_pixel_permutation(width, height, tile_w=TILE_W, tile_h=TILE_H):
    """Pixel order grouping rays into 16x8 screen tiles, so each 128-ray
    block covers a compact patch and lists few clusters. -> (perm, inv)
    numpy index arrays over H*W pixels."""
    if width % tile_w or height % tile_h:
        perm = np.arange(width * height)
        return perm, perm
    pix = np.arange(width * height)
    x, y = pix % width, pix // width
    tile = (y // tile_h) * (width // tile_w) + (x // tile_w)
    within = (y % tile_h) * tile_w + (x % tile_w)
    perm = np.argsort(tile * (tile_w * tile_h) + within, kind="stable")
    inv = np.argsort(perm, kind="stable")
    return perm, inv


def key_seed(seed: int) -> int:
    """The seed word the reference derives from ``jax.random.key(seed)``:
    the default threefry key keeps the seed's low 32 bits as its second
    word (the first is 0), and the reference folds the key as
    ``first * 0x9E3779B1 ^ second``."""
    return int(seed) & _M32


def _mul32(a, m: int):
    """(a * m) mod 2^32 for int64 a in [0, 2^32) without int64 overflow:
    split a into 16-bit halves so no partial product exceeds 2^48."""
    lo = a & 0xFFFF
    hi = a >> 16
    return ((lo * m) + (((hi * m) & 0xFFFF) << 16)) & _M32


def ray_uniforms(seed_word: int, pixel_ids, sample_ids, max_depth,
                 dtype=torch.float32):
    """(N, n_uniform_dims(max_depth)) uniforms in [0, 1) from global
    (pixel, sample, dim) counters: murmur3-style finalizer over the tuple,
    the reference's ``_ray_uniforms``."""
    nd = n_uniform_dims(max_depth)
    pid = pixel_ids.to(torch.int64)[:, None]
    sid = sample_ids.to(torch.int64)[:, None]
    dim = torch.arange(nd, dtype=torch.int64, device=pid.device)[None, :]
    h = ((_mul32(pid, 0x9E3779B1) ^ _mul32(sid, 0x85EBCA77)
          ^ _mul32(dim, 0xC2B2AE3D)) + seed_word) & _M32
    for mult in (0x7FEB352D, 0x846CA68B):
        h = h ^ (h >> 16)
        h = _mul32(h, mult)
    h = h ^ (h >> 16)
    # 24 mantissa-safe bits -> [0, 1)
    return (h >> 8).to(dtype) * (1.0 / (1 << 24))


def trace_pixels(scene, cam, width, height, pixel_ids, sample_ids,
                 seed_word, max_depth, chunk=2048, return_alive=False,
                 device=None):
    """Trace one flat batch of (pixel, sample) rays -> (B, 3) radiance
    (the reference's ``_trace_pixels``)."""
    from ..core.camera import camera_rays
    from ..device import resolve_device
    from ..integrator import path

    dev = resolve_device(device)
    pixel_ids, sample_ids = pixel_ids.to(dev), sample_ids.to(dev)
    u = ray_uniforms(seed_word, pixel_ids, sample_ids, max_depth)
    i = (pixel_ids % width).to(u.dtype)
    j = (pixel_ids // width).to(u.dtype)
    o, d = camera_rays(cam.to(dev), width, height, i, j, u[:, :4])
    return path.trace(scene, o, d, u, max_depth=max_depth, chunk=chunk,
                      return_alive=return_alive, device=dev)
