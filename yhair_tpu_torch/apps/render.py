"""Offline render CLI of the port (``yhair_tpu/apps/render.py``).

  python -m yhair_tpu_torch.apps.render (--scene scene.json | --config 3) \\
      [--resolution 256] [--spp 16] [--bounces 6] \\
      [--sampler path|naive|eyelight] [--seed 0] [--output out.png] \\
      [--hdr out.pfm|.exr|.hdr|.npy] [--exposure 0] [--filmic] \\
      [--checkpoint render.ckpt] [--spp-per-pass 1] [--no-bvh] \\
      [--accel auto|cluster|bvh|brute] [--debug-nans] [--device cuda]

Renders in tile-permuted strips of at most 65,536 rays with the
reference's counter-hash uniforms (the same seed gives the reference's
sample streams), through the cluster search on the card and the BVH walk
on the CPU (--accel auto), unless the scene is tiny or --accel brute /
--no-bvh ask for the brute-force scan. A scene file
renders at 256x256, 16 spp, 6 bounces unless told otherwise; a ladder
config at its own spec. --output is tonemapped for .png/.jpg and written
as HDR for any other suffix; --checkpoint resumes an interrupted render
bit for bit.
"""

from __future__ import annotations

import argparse
import time

from ..accel.traverse import DeviceBVH
from ..io import image as img_io
from ..io.image import load_pfm, save_pfm  # noqa: F401 (re-exported)
from .common import (build_device_scene, load_config,  # noqa: F401
                     load_scene, progressive_render)

SCENE_FILE_SPEC = {"res": 256, "spp": 16, "depth": 6}


def build_parser():
    p = argparse.ArgumentParser(prog="yhair-torch-render",
                                description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="scene JSON path")
    src.add_argument("--config", type=int, choices=range(1, 6),
                     help="builtin ladder config (scenes.generators.CONFIGS)")
    p.add_argument("--resolution", type=int, default=None,
                   help="square image size (default: the config's, or 256)")
    p.add_argument("--samples", "--spp", dest="spp", type=int, default=None)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--sampler", choices=["path", "naive", "eyelight"],
                   default="path")
    p.add_argument("--output", default="out.png",
                   help=".png/.jpg (tonemapped) or .pfm/.exr/.hdr/.npy")
    p.add_argument("--hdr", default=None,
                   help="also save HDR (.pfm/.exr/.hdr/.npy)")
    p.add_argument("--exposure", type=float, default=0.0)
    p.add_argument("--filmic", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="render-state file: resumed from, saved to")
    p.add_argument("--spp-per-pass", type=int, default=1)
    p.add_argument("--no-bvh", action="store_true",
                   help="no acceleration structure: the brute-force scan")
    p.add_argument("--accel", choices=["auto", "cluster", "bvh", "brute"],
                   default="auto",
                   help="intersection backend (auto: cluster on the card, "
                        "bvh on the CPU)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first NaN-producing op "
                        "(utils/debug.py)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def main(argv=None):
    """Render and write the image; -> {"scene", "camera", "image",
    "load_s", "render_s"}: the scene and camera as built, the HDR image,
    and the seconds of reading and building the scene and of the
    render."""
    args = build_parser().parse_args(argv)
    if args.debug_nans:
        from ..utils.debug import enable_debug_nans
        enable_debug_nans()
    t0 = time.time()
    scene_d, cam_d = load_scene(args)
    if args.config is not None:
        from scenes.generators import CONFIGS
        spec = CONFIGS[args.config]
    else:
        spec = SCENE_FILE_SPEC
    res = args.resolution or spec["res"]
    spp = args.spp or spec["spp"]
    depth = args.bounces or spec["depth"]
    sc, cam = build_device_scene(scene_d, cam_d, use_bvh=not args.no_bvh,
                                 accel=args.accel, device=args.device)
    load_s = time.time() - t0
    if sc.accel is None:
        accel = "none"
    elif isinstance(sc.accel, DeviceBVH):
        accel = f"bvh, {sc.accel.n_leaves} leaves"
    else:
        accel = f"{sc.accel.n_clusters} clusters"
    print(f"scene: {sc.segments.p0.shape[0]} segments, "
          f"{sc.n_triangles} triangles, {sc.n_lights} point lights, "
          f"{sc.n_area_lights} area lights, env map "
          f"{tuple(sc.env_map.shape[:2])}, accel {accel} ({load_s:.1f}s)")
    t1 = time.time()
    img = progressive_render(sc, cam, res, res, spp, depth, seed=args.seed,
                             sampler=args.sampler,
                             checkpoint=args.checkpoint,
                             spp_per_pass=args.spp_per_pass,
                             device=args.device)
    render_s = time.time() - t1
    img_io.save_image(args.output, img, exposure=args.exposure,
                      filmic=args.filmic)
    print(f"wrote {args.output} ({res}x{res}, {spp} spp, depth {depth}, "
          f"{args.sampler}, {time.time() - t0:.1f}s total)")
    if args.hdr:
        img_io.save_hdr(args.hdr, img)
        print(f"wrote {args.hdr}")
    return {"scene": sc, "camera": cam, "image": img, "load_s": load_s,
            "render_s": render_s}


if __name__ == "__main__":
    main()
