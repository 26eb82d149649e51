"""Traffic kind ``render``: a progressive-render job, one closed loop of
whole images through ``apps/common.progressive_render`` (1 sample a
pass, strips of 65,536 rays, float64 accumulation, no checkpoint), each
image with its own seed and ending in its own readback to the host.
Image k of the window has the seed --seed + 1 + k; set-up warms up with
one 1-sample image of seed --seed.

The check: after the window, ``check_tiles`` 16x8 pixel tiles of every
image, drawn from --seed, are rendered again by the plain reference;
compared is each image's relative L1 gap over those pixels (the sum of
absolute differences over the sum of the reference's values), the worst
image's. The control: the reference in a lower precision renders the
same pixels of the same images in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

UNIT = "image"
TILE_W, TILE_H = 16, 8


def samples_per_unit(w):
    return w["width"] * w["height"] * w["spp"]


def tiny(w):
    """The cell cut to the CPU tests' size: a 32x32 image at depth 2,
    2 samples a pixel (1 where the cell takes 1), 2 tiles checked."""
    return dict(w, width=32, height=32, spp=min(w["spp"], 2), max_depth=2,
                check_tiles=2)


def image_seed(seed, k):
    return int(seed) + 1 + k


class State:
    pass


def setup(run, fault=None):
    from yhair_tpu_torch.apps import common
    from yhair_tpu_torch.apps.common import build_device_scene

    from perfbench.lib.harness import now

    w, dev = run.workload, run.device
    st = State()
    t0 = now()
    st.scene_d, st.cam_d = run.scene()
    run.note("scene generated", t0)
    t0 = now()
    st.sc, st.cam = build_device_scene(st.scene_d, st.cam_d, accel="cluster",
                                       device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.scene_build_s = now() - t0
    run.note("scene built", t0)
    st.render = common.progressive_render if fault is None else fault(
        common.progressive_render)
    st.seed = run.seed
    st.w = w
    st.dev = dev
    # warm-up: every strip shape a pass uses, once
    t0 = now()
    st.render(st.sc, st.cam, w["width"], w["height"], 1, w["max_depth"],
              seed=run.seed, log=None, device=dev)
    run.note("warm image", t0)
    st.images = []
    return st


def unit(st, k):
    w = st.w
    img = st.render(st.sc, st.cam, w["width"], w["height"], w["spp"],
                    w["max_depth"], seed=image_seed(st.seed, k), log=None,
                    device=st.dev)
    st.images.append(np.asarray(img))


def release(st):
    st.sc = st.cam = st.render = None


def failed_units(st):
    return sum(1 for img in st.images if not np.isfinite(img).all())


def check_pixels(w, seed, k):
    """Row-major pixel indices of the tiles compared in image k."""
    tiles_x, tiles_y = w["width"] // TILE_W, w["height"] // TILE_H
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, k])
    tiles = rng.choice(tiles_x * tiles_y, size=w["check_tiles"],
                       replace=False)
    ty, tx = tiles // tiles_x, tiles % tiles_x
    yy, xx = np.meshgrid(np.arange(TILE_H), np.arange(TILE_W), indexing="ij")
    y = (ty[:, None] * TILE_H + yy.reshape(-1)[None]).reshape(-1)
    x = (tx[:, None] * TILE_W + xx.reshape(-1)[None]).reshape(-1)
    return y * w["width"] + x


def reference_pixels(st, w, k, pixels, device, dtype=torch.float32):
    from perfbench.reference import tracer
    return tracer.render_pixels(
        st.scene_d, st.cam_d, w, image_seed(st.seed, k),
        torch.as_tensor(pixels, device=device), device, dtype).cpu().numpy()


def image_gap(prog, ref):
    """Relative L1 gap of (P, 3) pixel values against the reference's."""
    prog = np.asarray(prog, np.float64)
    if not np.isfinite(prog).all():
        return float("inf")
    return float(np.abs(prog - ref).sum() / max(np.abs(ref).sum(), 1e-30))


def check(run, st, dtype=None):
    """-> {"image_gap": the worst image's gap}: each image of the window
    against the reference, or with ``dtype`` the reference in that
    precision in the program's place."""
    w = run.workload
    worst = 0.0
    for k, img in enumerate(st.images):
        px = check_pixels(w, st.seed, k)
        ref = reference_pixels(st, w, k, px, run.device)
        got = (img.reshape(-1, 3)[px] if dtype is None else
               reference_pixels(st, w, k, px, run.device, dtype))
        worst = max(worst, image_gap(got, ref))
    return {"image_gap": worst}


def control(run, st, dtype):
    return check(run, st, dtype)
