"""What the apps share (``yhair_tpu/apps/common.py``): loading a scene
from a file or a ladder config, building its tensors and acceleration on
a device, and the progressive renderer."""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..parallel import mesh
from ..utils import checkpoint as ckpt
from ..utils import trace

# scenes of at most this many segments get no acceleration structure
BRUTE_FORCE_SEGMENTS = 64


def load_scene(args):
    """-> (scene dict, camera dict) from ``args.scene`` (a scene file)
    or ``args.config`` (a ladder config of ``scenes.generators``)."""
    if getattr(args, "scene", None):
        from ..io import scene_json
        return scene_json.load(args.scene)
    from scenes.generators import CONFIGS
    return CONFIGS[int(args.config)]["fn"]()


def build_device_scene(scene_d, cam_d, use_bvh=True, leaf_size=4,
                       accel="auto", device=None):
    """-> (Scene, Camera) on ``device`` (the card unless ``device="cpu"``).

    accel: 'cluster' (the cluster search: the two CUDA kernels on the
    card, their plain versions on the CPU), 'bvh' (the skip-pointer BVH
    walk in torch ops, whose leaves hold ``leaf_size`` segments), 'brute'
    (no structure: the brute-force scan), or 'auto' (the cluster search
    on the card, the BVH on the CPU, as the reference picks by
    platform). Scenes of at most ``BRUTE_FORCE_SEGMENTS`` segments, or
    with use_bvh False, get no structure, as in the reference.
    """
    from ..accel import build_scene_bvh
    from ..core import scene as tscene
    from ..ops import build_scene_clusters

    if accel not in ("auto", "cluster", "bvh", "brute"):
        raise ValueError(f"unknown accel {accel!r}")
    dev = resolve_device(device)
    sc = tscene.from_dict(scene_d, device=dev)
    cam = tscene.camera_from_dict(cam_d, device=dev)
    if not use_bvh or sc.segments.p0.shape[0] <= BRUTE_FORCE_SEGMENTS:
        return sc, cam
    if accel == "auto":
        accel = "bvh" if dev.type == "cpu" else "cluster"
    if accel == "cluster":
        sc, _ = build_scene_clusters(sc, device=dev)
    elif accel == "bvh":
        sc, _ = build_scene_bvh(sc, leaf_size=leaf_size, device=dev)
    return sc, cam


def load_config(n, device=None):
    """-> (scene with clusters, camera, res, spp, depth) of ladder config
    n, on ``device``."""
    from scenes.generators import CONFIGS

    cfg = CONFIGS[n]
    sc, cam = build_device_scene(*cfg["fn"](), accel="cluster",
                                 device=device)
    return sc, cam, cfg["res"], cfg["spp"], cfg["depth"]


class PassPlan(NamedTuple):
    """How one pass of spp_per_pass samples per pixel is traced."""
    width: int
    height: int
    spp_per_pass: int
    strip: int                # rays per strip; the strips tile the pass
    pid: torch.Tensor         # (W*H*spp_per_pass,) pixel id of each ray
    sid: torch.Tensor         # (W*H*spp_per_pass,) sample within the pass
    inv: torch.Tensor         # (W*H,) tile order -> row-major pixel order


def pass_plan(width, height, spp_per_pass, max_rays_per_call, device):
    """Rays in tile-permuted pixel order, a pixel's samples contiguous,
    cut into the fewest equal strips of at most max_rays_per_call rays
    (the count is raised until it divides the rays, as the reference's
    loop does)."""
    n_rays = width * height * spp_per_pass
    n_strips = max(1, -(-n_rays // max_rays_per_call))
    while n_rays % n_strips:
        n_strips += 1
    perm, inv = mesh.tile_pixel_permutation(width, height)
    return PassPlan(
        width, height, spp_per_pass, n_rays // n_strips,
        torch.as_tensor(np.repeat(perm, spp_per_pass), device=device),
        torch.arange(spp_per_pass, device=device).repeat(width * height),
        torch.as_tensor(inv, dtype=torch.int64, device=device))


def render_pass(scene, cam, plan, sample0, seed_word, max_depth,
                sampler="path", edge_softness=0.0):
    """Samples [sample0, sample0 + plan.spp_per_pass) of every pixel ->
    (W*H, 3) float64 sum per pixel, row-major."""
    with trace.span("yhair.pass"):
        dev = plan.pid.device
        flat = torch.empty((plan.pid.shape[0], 3), dtype=torch.float64,
                           device=dev)
        for a in range(0, plan.pid.shape[0], plan.strip):
            sl = slice(a, a + plan.strip)
            flat[sl] = mesh.trace_pixels(
                scene, cam, plan.width, plan.height, plan.pid[sl],
                sample0 + plan.sid[sl], seed_word, max_depth,
                sampler=sampler, edge_softness=edge_softness, device=dev)
        return flat.reshape(-1, plan.spp_per_pass, 3).sum(1)[plan.inv]


@torch.no_grad()
def progressive_render(scene, cam, width, height, spp, max_depth, seed=0,
                       sampler="path", checkpoint=None, checkpoint_every=8,
                       log=print, spp_per_pass=1, max_rays_per_call=65536,
                       edge_softness=0.0, device=None):
    """Render spp samples in passes of spp_per_pass, each pass in equal
    tile-aligned strips of at most max_rays_per_call rays (a pixel's
    samples of a pass are contiguous), summed in float64. No graph is
    kept, even for a scene with trainable leaves.

    checkpoint: a render-state file (``utils.checkpoint``), resumed from
    if it exists (it must hold the same seed), saved every
    checkpoint_every passes and at the end.

    -> (H, W, 3) numpy image, the sum over the samples rendered divided
    by their count.
    """
    dev = resolve_device(device)
    scene, cam = scene.to(dev), cam.to(dev)
    accum = torch.zeros((height * width, 3), dtype=torch.float64, device=dev)
    start = 0
    if checkpoint and os.path.exists(checkpoint):
        st = ckpt.load_render_state(checkpoint)
        if st["seed"] != seed:
            raise ValueError(f"{checkpoint} was rendered with seed "
                             f"{st['seed']}, not {seed}")
        if st["accum"].shape != (height, width, 3):
            raise ValueError(f"{checkpoint} holds a {st['accum'].shape} "
                             f"image, not {(height, width, 3)}")
        accum += torch.as_tensor(st["accum"].reshape(-1, 3), device=dev)
        start = st["next_sample"]
        if log:
            log(f"resumed at sample {start}")

    plan = pass_plan(width, height, spp_per_pass, max_rays_per_call, dev)
    seed_word = mesh.key_seed(seed)

    def save(n):
        ckpt.save_render_state(
            checkpoint, accum.reshape(height, width, 3).cpu().numpy(), n,
            seed)

    t0 = time.time()
    s = start
    while s < spp:
        accum += render_pass(scene, cam, plan, s, seed_word, max_depth,
                             sampler, edge_softness)
        s += spp_per_pass
        if checkpoint and (s // spp_per_pass) % checkpoint_every == 0:
            save(s)
        if log:
            rate = (s - start) * width * height / max(time.time() - t0,
                                                      1e-9) / 1e6
            log(f"  sample {s}/{spp}  ({rate:.3f} Mcam-rays/s)")
    if checkpoint:
        save(s)
    return (accum / max(s, 1)).reshape(height, width, 3).cpu().numpy()
