"""Pinhole / thin-lens camera (``yhair_tpu/core/camera.py``)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .safemath import sqrt_rn


class Camera(NamedTuple):
    position: torch.Tensor    # (3,)
    look_at: torch.Tensor     # (3,)
    up: torch.Tensor          # (3,)
    vfov_deg: torch.Tensor    # ()
    aperture: torch.Tensor    # () lens diameter; 0 = pinhole
    focus_dist: torch.Tensor  # () distance to the focal plane

    @classmethod
    def make(cls, position, look_at, up=(0.0, 1.0, 0.0), vfov_deg=35.0,
             aperture=0.0, focus_dist=None, device="cpu"):
        if focus_dist is None:
            focus_dist = float(np.linalg.norm(
                np.asarray(look_at, float) - np.asarray(position, float)))

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        return cls(t(position), t(look_at), t(up), t(vfov_deg),
                   t(aperture), t(focus_dist))

    @classmethod
    def from_dict(cls, cam, device="cpu"):
        return cls.make(cam["position"], cam["look_at"],
                        cam.get("up", (0.0, 1.0, 0.0)), cam["vfov_deg"],
                        cam.get("aperture", 0.0), cam.get("focus_dist"),
                        device=device)

    def to(self, device):
        return Camera(*(a.to(device) for a in self))


def _normalize(v):
    # correctly rounded root of the sequential sum of squares: the
    # reference's jnp.linalg.norm value bit for bit
    n = sqrt_rn((v * v).sum(-1, keepdim=True))
    return v / torch.clamp(n, min=1e-12)


def camera_rays(cam: Camera, width, height, i, j, u_px):
    """Primary rays. i, j: (N,) pixel column/row; u_px: (N, 4) subpixel
    jitter [:, 0:2] and lens sample [:, 2:4]. -> (o, d), each (N, 3).
    Row 0 is the top of the image."""
    fwd = _normalize(cam.look_at - cam.position)
    right = _normalize(torch.linalg.cross(fwd, cam.up))
    up = torch.linalg.cross(right, fwd)
    tan_half = torch.tan(cam.vfov_deg * (math.pi / 180.0) * 0.5)
    aspect = width / height
    sx = (i + u_px[:, 0]) / width * 2.0 - 1.0
    sy = 1.0 - (j + u_px[:, 1]) / height * 2.0
    d = (fwd[None, :] + (sx * tan_half * aspect)[:, None] * right[None, :]
         + (sy * tan_half)[:, None] * up[None, :])
    o = cam.position.expand(d.shape)
    r = cam.aperture * 0.5 * torch.sqrt(u_px[:, 2])
    theta = 2.0 * math.pi * u_px[:, 3]
    lens = ((r * torch.cos(theta))[:, None] * right[None, :]
            + (r * torch.sin(theta))[:, None] * up[None, :])
    focal_pt = o + d * cam.focus_dist
    o = o + lens
    d = torch.where(cam.aperture > 0.0, focal_pt - o, d)
    return o, _normalize(d)
