"""The plain reference's melanin inverse: hair absorption from the
eumelanin and pheomelanin concentrations, and the first steps of an
inverse run whose leaves hold those concentrations in place of sigma_a.

``sigma_a_from_concentration`` is written from the published constants
(pbrt-v3 ``HairBSDF::SigmaAFromConcentration``; Chiang et al. 2016, "A
Practical and Controllable Hair and Fur Model for Production Path
Tracing"): sigma_a = c_e (0.419, 0.697, 1.37) + c_p (0.187, 0.4, 1.05),
the products then the sum, in the inputs' dtype. ``train_steps`` is
``tracer.train_steps`` with that map: before each strip the two
concentration leaves give sigma_a under autograd (a strip's backward
frees the map's graph), the other leaves replace their fields.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tracer
from .scene import from_dict

EUMELANIN = (0.419, 0.697, 1.37)
PHEOMELANIN = (0.187, 0.4, 1.05)
MELANIN = ("eumelanin", "pheomelanin")
# the concentrations' bounds: at both upper ends sigma_a is at most
# 10 x 1.37 + 5 x 1.05 = 18.95, inside its own (0, 20)
PARAM_BOUNDS = dict(tracer.PARAM_BOUNDS, eumelanin=(0.0, 10.0),
                    pheomelanin=(0.0, 5.0))


def sigma_a_from_concentration(ce, cp):
    """(...,) concentrations, tensors of one dtype and device -> (..., 3)
    absorption."""
    e = torch.tensor(EUMELANIN, dtype=ce.dtype, device=ce.device)
    p = torch.tensor(PHEOMELANIN, dtype=ce.dtype, device=ce.device)
    return ce[..., None] * e + cp[..., None] * p


def train_steps(scene_d, cam, target, w, seed, n_steps, device, dtype,
                init):
    """The first n_steps of a melanin inverse run, as the cell sets it
    up: ``tracer.train_steps``'s loss, gradients, Adam and bounds, with
    the leaves ``eumelanin`` and ``pheomelanin`` mapped to sigma_a.
    -> {"loss": [...], "grad1": {leaf: tensor}, "params": [{leaf:
    tensor} after each step]}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sc = from_dict(scene_d, device, dtype)
    width, height, spp = w["width"], w["height"], w["spp"]
    order = torch.as_tensor(tracer.tile_order(width, height), device=device)
    tile_px = tracer.TILE_W * tracer.TILE_H
    tgt = target.to(device=device, dtype=dtype).reshape(-1, 3)
    params = {k: torch.tensor(np.asarray(init[k], np.float32), device=device,
                              requires_grad=True) for k in w["params"]}
    opt = torch.optim.Adam(list(params.values()), lr=w["lr"])
    gen = torch.Generator().manual_seed(int(seed))
    out = {"loss": [], "grad1": None, "params": []}
    for it in range(n_steps):
        if w["pixel_batch"] is None:
            pixels = order
        else:
            tiles = tracer.draw_tiles(order.numel() // tile_px,
                                      w["pixel_batch"] // tile_px, gen)
            pixels = order.reshape(-1, tile_px)[tiles.to(device)].reshape(-1)
        n = pixels.numel() * 3
        for p in params.values():
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=device)
        px_strip = tracer.STRIP_RAYS // spp
        for a in range(0, pixels.numel(), px_strip):
            hair = dict(sc.hair, **{k: v.to(dtype) for k, v in params.items()
                                    if k not in MELANIN})
            hair["sigma_a"] = sigma_a_from_concentration(
                params["eumelanin"].to(dtype), params["pheomelanin"].to(dtype))
            scp = sc._replace(hair=hair)
            px = pixels[a:a + px_strip]
            img = tracer.pixel_samples(scp, cam, width, height, px, spp,
                                       tracer.step_seed(seed, it),
                                       w["max_depth"], dtype).mean(1)
            part = ((img - tgt[px]) ** 2).sum() / n
            part.backward()
            loss = loss + part.detach().float()
        for p in params.values():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = torch.where(torch.isfinite(g), g, 0.0)
        opt.step()
        with torch.no_grad():
            for k, p in params.items():
                p.clamp_(*PARAM_BOUNDS[k])
        if it == 0:
            out["grad1"] = {k: opt.state[p]["exp_avg"].detach().clone()
                            / (1.0 - opt.defaults["betas"][0])
                            if p in opt.state else torch.zeros_like(p)
                            for k, p in params.items()}
        out["loss"].append(float(loss))
        out["params"].append({k: v.detach().clone()
                              for k, v in params.items()})
    return out
