"""Progressive viewer of the port (``yhair_tpu/apps/view.py``).

Renders one pass per iteration and writes the tonemapped preview PNG
after every pass, watching an edits file: a small JSON of camera,
hair-material and tonemap overrides. A saved change is picked up at the
next pass boundary and restarts the accumulation.

  python -m yhair_tpu_torch.apps.view --config 3 --resolution 256 \\
      --output /tmp/view.png --edits /tmp/edits.json

  # in another shell, live-edit:
  echo '{"beta_m": 0.1, "sigma_a": [0.2, 0.4, 0.9], "exposure": 1.0}' \\
      > /tmp/edits.json

Edit keys: beta_m, beta_n, alpha, eta, sigma_a ([3]), color ([3],
through sigma_a_from_reflectance), melanin ([ce, cp]), cam_from ([3]),
cam_to ([3]), fov (deg), aperture, exposure, filmic. Unknown keys are
reported and ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..bsdf import hair as th
from ..core import scene as tscene
from ..io import image as img_io
from ..parallel import mesh
from .common import build_device_scene, load_scene, pass_plan, render_pass


def build_parser():
    p = argparse.ArgumentParser(prog="yhair-torch-view", description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="scene JSON path")
    src.add_argument("--config", type=int, choices=range(1, 6))
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--sampler", choices=["path", "naive", "eyelight"],
                   default="path")
    p.add_argument("--output", default="view.png",
                   help="preview PNG, rewritten after every pass")
    p.add_argument("--edits", default=None,
                   help="JSON file watched for live parameter edits")
    p.add_argument("--spp-per-pass", type=int, default=1)
    p.add_argument("--max-spp", type=int, default=0,
                   help="stop after this many samples (0 = run forever)")
    p.add_argument("--max-passes", type=int, default=0,
                   help="stop after this many passes (0 = unlimited)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--accel", choices=["auto", "cluster", "bvh", "brute"],
                   default="auto",
                   help="intersection backend (auto: cluster on the card, "
                        "bvh on the CPU)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def _apply_edits(edits, sc, cam_d, tonemap):
    """Apply an edits dict -> (scene, cam dict, Camera, tonemap). Unknown
    keys are reported, not fatal (a typo must not end the viewer)."""
    dev = sc.env.device
    hair = sc.hair
    cam_d = dict(cam_d)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)
    for k, v in edits.items():
        if k in ("beta_m", "beta_n", "alpha", "eta"):
            hair = hair._replace(**{k: f32(v)})
        elif k == "sigma_a":
            hair = hair._replace(sigma_a=f32(v))
        elif k == "color":
            hair = hair._replace(sigma_a=th.sigma_a_from_reflectance(
                f32(v), hair.beta_n))
        elif k == "melanin":
            hair = hair._replace(sigma_a=th.sigma_a_from_concentration(
                f32(v[0]), f32(v[1])))
        elif k == "cam_from":
            cam_d["position"] = list(map(float, v))
        elif k == "cam_to":
            cam_d["look_at"] = list(map(float, v))
        elif k == "fov":
            cam_d["vfov_deg"] = float(v)
        elif k == "aperture":
            cam_d["aperture"] = float(v)
        elif k == "exposure":
            tonemap["exposure"] = float(v)
        elif k == "filmic":
            tonemap["filmic"] = bool(v)
        else:
            print(f"  (ignoring unknown edit key {k!r})")
    return (sc._replace(hair=hair), cam_d,
            tscene.camera_from_dict(cam_d, device=dev), tonemap)


def _read_edits(path, mtime):
    """-> (edits dict or None, the file's mtime): None when the file is
    absent, unchanged since ``mtime`` or unreadable."""
    if not path or not os.path.exists(path):
        return None, mtime
    m = os.path.getmtime(path)
    if m == mtime:
        return None, mtime
    try:
        with open(path) as f:
            return json.load(f), m
    except (OSError, json.JSONDecodeError) as e:
        print(f"  (edits unreadable: {e})")
        return None, m


@torch.no_grad()
def main(argv=None):
    args = build_parser().parse_args(argv)
    scene_d, cam_d = load_scene(args)
    res = args.resolution
    sc, cam = build_device_scene(scene_d, cam_d, accel=args.accel,
                                 device=args.device)
    dev = sc.env.device
    print(f"viewer: {sc.segments.p0.shape[0]} segments, {res}x{res}; "
          f"preview -> {args.output}"
          + (f", edits <- {args.edits}" if args.edits else ""))
    plan = pass_plan(res, res, args.spp_per_pass, mesh.MAX_RAYS_PER_STRIP,
                     dev)
    seed_word = mesh.key_seed(args.seed)
    tonemap = {"exposure": 0.0, "filmic": False}
    accum = torch.zeros((res * res, 3), dtype=torch.float64, device=dev)
    s = n_pass = 0
    edits_mtime = None
    t0 = time.time()
    try:
        while True:
            # edits apply at pass boundaries and restart the accumulation
            edits, edits_mtime = _read_edits(args.edits, edits_mtime)
            if edits is not None:
                sc, cam_d, cam, tonemap = _apply_edits(edits, sc, cam_d,
                                                       tonemap)
                if n_pass > 0:
                    accum.zero_()
                    s = 0
                    t0 = time.time()
                    print(f"  edits applied: {sorted(edits)} — "
                          "accumulation restarted")
            accum += render_pass(sc, cam, plan, s, seed_word, args.bounces,
                                 args.sampler)
            s += args.spp_per_pass
            n_pass += 1
            img = (accum / s).reshape(res, res, 3).cpu().numpy()
            img_io.save_png(args.output, img, exposure=tonemap["exposure"],
                            filmic=tonemap["filmic"])
            rate = s * res * res / max(time.time() - t0, 1e-9) / 1e6
            print(f"  pass {n_pass}: {s} spp ({rate:.2f} Mcam-rays/s)")
            if args.max_spp and s >= args.max_spp:
                break
            if args.max_passes and n_pass >= args.max_passes:
                break
    except KeyboardInterrupt:
        print("\nstopped")
    print(f"final preview: {args.output} ({s} spp)")


if __name__ == "__main__":
    main()
