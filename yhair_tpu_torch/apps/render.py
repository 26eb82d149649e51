"""Offline render CLI of the port (``yhair_tpu/apps/render.py``).

  python -m yhair_tpu_torch.apps.render --config 3 [--resolution 256] \\
      [--spp 16] [--bounces 6] [--sampler path|naive|eyelight] [--seed 0] \\
      [--output out.pfm] [--device cuda]

Renders in tile-permuted strips of at most 65,536 rays through the
cluster search, one sample per pass, with the reference's counter-hash
uniforms: the same seed gives the reference's sample streams. Writes
``.pfm`` or ``.npy``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..parallel import mesh


def save_pfm(path, img):
    """PFM: 'PF' header, W H, negative scale = little endian, bottom row
    first."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n-1.0\n".encode())
        f.write(np.flipud(img).astype("<f4").tobytes())


def load_pfm(path):
    with open(path, "rb") as f:
        magic = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3) if magic == b"PF" else data.reshape(h, w)
    return np.flipud(img).astype(np.float64)


@torch.no_grad()
def progressive_render(scene, cam, width, height, spp, max_depth, seed=0,
                       sampler="path", max_rays_per_call=65536,
                       edge_softness=0.0, return_alive=False, log=print,
                       device=None):
    """Render spp samples, one per pass, each pass in equal tile-aligned
    strips of at most max_rays_per_call rays; accumulate in float64.
    No graph is kept, even for a scene with trainable leaves.

    -> (H, W, 3) numpy image; with return_alive also the totals of
    (alive bounce rays, live shadow rays) over every strip.
    """
    from ..device import resolve_device
    dev = resolve_device(device)
    scene, cam = scene.to(dev), cam.to(dev)
    n_rays = width * height
    n_strips = max(1, -(-n_rays // max_rays_per_call))
    while n_rays % n_strips:
        n_strips += 1
    strip = n_rays // n_strips
    perm, inv = mesh.tile_pixel_permutation(width, height)
    pid_all = torch.as_tensor(perm, dtype=torch.int64, device=dev)
    inv = torch.as_tensor(inv, dtype=torch.int64, device=dev)
    seed_word = mesh.key_seed(seed)
    accum = torch.zeros((n_rays, 3), dtype=torch.float64, device=dev)
    alive = torch.zeros(2, dtype=torch.int64, device=dev)
    t0 = time.time()
    for s in range(spp):
        flat = torch.empty((n_rays, 3), dtype=torch.float64, device=dev)
        for b in range(n_strips):
            pid = pid_all[b * strip:(b + 1) * strip]
            sid = torch.full_like(pid, s)
            out = mesh.trace_pixels(scene, cam, width, height, pid, sid,
                                    seed_word, max_depth, sampler=sampler,
                                    edge_softness=edge_softness,
                                    return_alive=return_alive, device=dev)
            if return_alive:
                out, (a_in, a_sh) = out
                alive += torch.stack([a_in.sum(), a_sh.sum()])
            flat[b * strip:(b + 1) * strip] = out
        accum += flat[inv]
        if log:
            rate = (s + 1) * n_rays / max(time.time() - t0, 1e-9) / 1e6
            log(f"  sample {s + 1}/{spp}  ({rate:.3f} Mcam-rays/s)")
    img = (accum / max(spp, 1)).reshape(height, width, 3).cpu().numpy()
    if return_alive:
        return img, tuple(int(x) for x in alive.cpu())
    return img


def build_parser():
    p = argparse.ArgumentParser(prog="yhair-torch-render",
                                description=__doc__)
    p.add_argument("--config", type=int, choices=range(1, 6), required=True,
                   help="builtin ladder config (scenes.generators.CONFIGS)")
    p.add_argument("--resolution", type=int, default=None,
                   help="square image size (default: the config's)")
    p.add_argument("--samples", "--spp", dest="spp", type=int, default=None)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--sampler", choices=["path", "naive", "eyelight"],
                   default="path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="out.pfm", help=".pfm or .npy")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def load_config(n, device=None):
    """-> (scene with clusters, camera, res, spp, depth) of ladder config
    n, on ``device``."""
    from scenes.generators import CONFIGS

    from ..core import scene as tscene
    from ..ops import build_scene_clusters

    cfg = CONFIGS[n]
    scene_d, cam_d = cfg["fn"]()
    sc = tscene.from_dict(scene_d, device=device)
    sc, _ = build_scene_clusters(sc, device=device)
    cam = tscene.camera_from_dict(cam_d, device=device)
    return sc, cam, cfg["res"], cfg["spp"], cfg["depth"]


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.output.endswith((".pfm", ".npy")):
        raise SystemExit("--output must end in .pfm or .npy")
    t0 = time.time()
    sc, cam, res, spp, depth = load_config(args.config, device=args.device)
    res = args.resolution or res
    spp = args.spp or spp
    depth = args.bounces or depth
    print(f"scene: {sc.segments.p0.shape[0]} segments, "
          f"{sc.n_triangles} triangles, {sc.n_lights} point lights, "
          f"{sc.n_area_lights} area lights, env map "
          f"{tuple(sc.env_map.shape[:2])}, {sc.accel.n_clusters} clusters "
          f"({time.time() - t0:.1f}s)")
    img = progressive_render(sc, cam, res, res, spp, depth, seed=args.seed,
                             sampler=args.sampler, device=args.device)
    if args.output.endswith(".pfm"):
        save_pfm(args.output, img)
    else:
        np.save(args.output, img.astype(np.float32))
    print(f"wrote {args.output} ({res}x{res}, {spp} spp, depth {depth}, "
          f"{args.sampler}, {time.time() - t0:.1f}s total)")


if __name__ == "__main__":
    sys.exit(main())
