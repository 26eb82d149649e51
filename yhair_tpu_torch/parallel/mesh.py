"""Rendering and inverse-rendering steps over ranks
(``yhair_tpu/parallel/mesh.py``).

The reference shards the ray batch over a device mesh with
``shard_map``; here the ranks of a ``torch.distributed`` process group
take its place (``make_group``). The ray batch, in the screen-tile pixel
order, is cut into one contiguous share per rank; the scene is
replicated. ``render_fn`` combines the shares with one all-reduce in
which each element has exactly one nonzero contributor, so the image is
bit-identical for any world size; ``train_step_fn`` all-reduces the loss
and the gradients, so every rank takes the same step. The
per-(pixel, sample, dim) hash makes a ray's uniforms independent of the
batching. Each rank traces its share in tile-order strips of at most
``MAX_RAYS_PER_STRIP`` rays, which bounds the memory a strip's autograd
graph holds.

torch has no unsigned 32-bit shift or add on every device, so the hash is
done in int64 and cut back to 32 bits after every operation; the result
is bit-equal to the reference's uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..bsdf import hair as th
from ..core.rng import n_uniform_dims
from ..device import resolve_device
from ..utils import debug, trace

TILE_W, TILE_H = 16, 8
_M32 = 0xFFFFFFFF
# rays a training strip traces in one batch: a 512x512 1-spp frame is
# four strips, as bench.py traces it
MAX_RAYS_PER_STRIP = 65536

# valid ranges of the physical hair parameters: gradient steps must not
# leave the model's domain (the beta^20 terms explode past 1; negative
# absorption is meaningless); applied after every optimizer update
PARAM_BOUNDS = {
    "beta_m": (1e-3, 1.0),
    "beta_n": (1e-3, 1.0),
    "alpha": (0.0, 0.2),
    "sigma_a": (0.0, 20.0),
    "eta": (1.0, 2.0),
    # melanin concentrations: at both upper bounds the implied sigma_a is
    # at most 10 * 1.37 + 5 * 1.05 = 18.95, inside sigma_a's own bounds
    "eumelanin": (0.0, 10.0),
    "pheomelanin": (0.0, 5.0),
}
# leaves that together give the scene's sigma_a in place of a field
MELANIN = ("eumelanin", "pheomelanin")


def check_leaves(names):
    """Raise ValueError where the leaf names cannot set the hair: one
    melanin concentration without the other, or both beside sigma_a."""
    given = [k for k in MELANIN if k in names]
    if given and len(given) < len(MELANIN):
        raise ValueError("eumelanin and pheomelanin are leaves together: "
                         f"got only {given[0]}")
    if given and "sigma_a" in names:
        raise ValueError("sigma_a comes from eumelanin and pheomelanin: "
                         "it cannot be a leaf beside them")


def hair_with(hair, params):
    """The hair material with the leaves in place: each leaf replaces the
    field of its name, and eumelanin and pheomelanin replace sigma_a by
    ``sigma_a_from_concentration``, under autograd."""
    fields = {k: v for k, v in params.items() if k not in MELANIN}
    if MELANIN[0] in params:
        fields["sigma_a"] = th.sigma_a_from_concentration(
            params["eumelanin"], params["pheomelanin"])
    return hair._replace(**fields)


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
                 seed_word, max_depth, chunk=2048, sampler="path",
                 edge_softness=0.0, device=None):
    """Trace one flat batch of (pixel, sample) rays -> (B, 3) radiance
    (the reference's ``_trace_pixels``)."""
    from ..core.camera import camera_rays
    from ..integrator import path

    dev = resolve_device(device)
    pixel_ids, sample_ids = pixel_ids.to(dev), sample_ids.to(dev)
    with trace.span("yhair.rays"):
        u = ray_uniforms(seed_word, pixel_ids, sample_ids, max_depth)
        i = (pixel_ids % width).to(u.dtype)
        j = (pixel_ids // width).to(u.dtype)
        o, d = camera_rays(cam.to(dev), width, height, i, j, u[:, :4])
    return path.trace(scene, o, d, u, max_depth=max_depth, chunk=chunk,
                      sampler=sampler, edge_softness=edge_softness,
                      device=dev)


def make_group(ranks=None, device=None):
    """-> (process group, this rank's device): the counterpart of the
    reference's ``make_mesh``. The caller has run
    ``torch.distributed.init_process_group``. ranks: None for the
    default group, else a new group over those global ranks (every rank
    must call this then, as ``new_group`` requires). device: None for
    the card of this rank (global rank modulo the cards), or a device
    to use as given ("cpu" with the gloo backend)."""
    if not dist.is_initialized():
        raise RuntimeError("init_process_group first")
    group = dist.group.WORLD if ranks is None else dist.new_group(ranks)
    if device is None:
        resolve_device(None)
        device = torch.device("cuda",
                              dist.get_rank() % torch.cuda.device_count())
    return group, torch.device(device)


def _share(n, group):
    """This rank's contiguous slice of n items (all of them without a
    group)."""
    if group is None:
        return slice(0, n)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % world:
        raise ValueError(f"{n} rays or pixels do not divide over "
                         f"{world} ranks")
    k = n // world
    return slice(rank * k, (rank + 1) * k)


def render_fn(width, height, spp, max_depth=6, chunk=2048, sampler="path",
              edge_softness=0.0, group=None, device=None):
    """Build render(scene, cam, seed_word) -> (H, W, 3) float32 image,
    each pixel the mean of its spp samples.

    group: None traces every ray here; with a process group, rank r
    traces the r-th contiguous share of the tile-ordered flat ray list
    (the ray count must divide by the world size), in strips of at most
    ``MAX_RAYS_PER_STRIP`` rays, into a zero-filled (rays, 3) buffer
    that one ``all_reduce(SUM)`` combines. Each element has one nonzero
    contributor, so the sum is exact and the image the same for every
    world size. device: this rank's device (``make_group``'s).
    """
    dev = resolve_device(device)
    n_rays = width * height * spp
    share = _share(n_rays, group)
    perm, inv = tile_pixel_permutation(width, height)
    pid = torch.as_tensor(np.repeat(perm, spp), device=dev)
    sid = torch.arange(spp, device=dev).repeat(width * height)
    inv = torch.as_tensor(inv, dtype=torch.int64, device=dev)

    @torch.no_grad()
    def render(scene, cam, seed_word):
        flat = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
        for a in range(share.start, share.stop, MAX_RAYS_PER_STRIP):
            sl = slice(a, min(a + MAX_RAYS_PER_STRIP, share.stop))
            flat[sl] = trace_pixels(scene, cam, width, height, pid[sl],
                                    sid[sl], seed_word, max_depth, chunk,
                                    sampler, edge_softness, device=dev)
        if group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        img = flat.reshape(-1, spp, 3).mean(1)[inv]
        return img.reshape(height, width, 3)
    return render


def pixel_strips(n_pixels, spp):
    """Slices of a pixel list, each traced as one batch of at most
    ``MAX_RAYS_PER_STRIP`` rays. A pixel's spp rays are contiguous, so a
    strip holds whole pixels, and a strip of a tile or more holds whole
    16x8 tiles of the tile order."""
    px = max(1, MAX_RAYS_PER_STRIP // spp)
    if px >= TILE_W * TILE_H:
        px -= px % (TILE_W * TILE_H)
    return [slice(a, min(a + px, n_pixels)) for a in range(0, n_pixels, px)]


def pixel_means(scene, cam, width, height, pixels, spp, seed_word,
                max_depth, chunk=2048, edge_softness=0.0, device=None):
    """(P, 3) mean of each pixel's spp samples, its rays traced
    contiguously in one batch."""
    dev = resolve_device(device)
    pixels = pixels.to(dev)
    pid = pixels.repeat_interleave(spp)
    sid = torch.arange(spp, device=dev).repeat(pixels.shape[0])
    L = trace_pixels(scene, cam, width, height, pid, sid, seed_word,
                     max_depth, chunk=chunk, edge_softness=edge_softness,
                     device=dev)
    return L.reshape(-1, spp, 3).mean(1)


def draw_tiles(n_tiles, k, generator):
    """k distinct tile indices in [0, n_tiles), drawn without
    replacement from ``generator`` (a CPU ``torch.Generator``)."""
    return torch.randperm(n_tiles, generator=generator)[:k]


def _all_reduce_sum(group, loss, *grads):
    """Sum the loss (returned) and the gradients (in place) over the
    group's ranks in one all-reduce of a flat buffer."""
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    at = 1
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[0]


def train_step_fn(width, height, spp, max_depth=6, chunk=2048,
                  pixel_batch=None, edge_softness=0.0, group=None,
                  device=None):
    """Build an inverse-rendering step:
    step(params, opt, scene, cam, target, seed_word, generator=None)
        -> (loss, grads)

    params: {name: leaf tensor with requires_grad} of ``HairMaterial``
    fields, which replace the scene's (scalar or (3,) leaves, or rows of
    a per-shape table: (Mh,) / (Mh, 3)), or the melanin concentrations
    ``eumelanin`` and ``pheomelanin`` together and without ``sigma_a``
    (``check_leaves``), scalars or (Mh,) rows, which replace sigma_a by
    ``sigma_a_from_concentration`` (``hair_with``, in a
    ``yhair.params`` span before each strip: a strip's backward frees
    the map's graph). The concentration leaves widen the reference,
    whose step takes ``HairMaterial`` fields alone; opt: a ``torch.optim`` optimizer
    over those leaves (``torch.optim.Adam(lr)`` is optax's ``adam(lr)``);
    target: (H, W, 3). The loss is the mean squared error of the pixel
    means against the target. Each strip calls ``backward`` on its share
    of the loss, so the gradients accumulate to the whole batch's (up to
    f32 summation order). With a process group (``make_group``), every
    rank draws the same pixels (its generator seeded as the others'),
    traces the r-th contiguous share of them, and its strips' parts of
    the global loss (each over the global 3 P) are summed over the ranks
    with the gradients in one ``all_reduce(SUM)``: every rank then steps
    the same gradient, and the params stay equal on every rank. The
    pixel count must divide by the world size. Then, in the reference's
    order: the loss and
    gradients go through ``utils.debug.assert_finite`` (which raises
    only when YHAIR_CHECK_FINITE=1), non-finite gradient entries become
    0, ``opt.step()``, and each param is clamped in place to
    ``PARAM_BOUNDS``, entry by entry. Returns the loss and
    the (sanitized) gradients. edge_softness: soft strand silhouettes
    (``integrator.path.trace``).

    pixel_batch: each step traces that many pixels, whole 16x8 tiles
    drawn without replacement from ``generator`` by ``draw_tiles``, and
    descends on their MSE, an unbiased estimate of the image's. It must
    be a multiple of 128 that the image holds, and the image must hold
    whole tiles.
    """
    dev = resolve_device(device)
    tile_px = TILE_W * TILE_H
    if pixel_batch is not None and (
            pixel_batch % tile_px or (width * height) % tile_px
            or pixel_batch > width * height):
        raise ValueError(f"pixel_batch must be a multiple of {tile_px} "
                         f"and tile the image")
    n_pixels = width * height if pixel_batch is None else pixel_batch
    _share(n_pixels, group)           # raises unless it divides
    perm, _ = tile_pixel_permutation(width, height)
    all_pixels = torch.as_tensor(perm, device=dev)

    def step(params, opt, scene, cam, target, seed_word, generator=None):
        check_leaves(params)
        with trace.span("yhair.step"):
            if pixel_batch is None:
                pixels = all_pixels
            else:
                if generator is None:
                    raise ValueError("pixel_batch draws its tiles from a "
                                     "generator: pass one")
                tiles = draw_tiles(all_pixels.numel() // tile_px,
                                   pixel_batch // tile_px, generator)
                pixels = all_pixels.reshape(-1, tile_px)[tiles.to(dev)]
                pixels = pixels.reshape(-1)
            tgt = target.to(dev).reshape(-1, 3)
            n = pixels.numel() * 3
            for p in params.values():
                p.grad = None
            loss = torch.zeros((), device=dev)
            mine = pixels[_share(pixels.numel(), group)]
            for sl in pixel_strips(mine.numel(), spp):
                with trace.span("yhair.params"):
                    sc = scene._replace(hair=hair_with(scene.hair, params))
                img = pixel_means(sc, cam, width, height, mine[sl], spp,
                                  seed_word, max_depth, chunk, edge_softness,
                                  dev)
                part = ((img - tgt[mine[sl]]) ** 2).sum() / n
                with trace.span("yhair.backward"):
                    part.backward()
                loss = loss + part.detach()
            for p in params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            with trace.span("yhair.adam"):
                if group is not None:
                    loss = _all_reduce_sum(group, loss,
                                           *(p.grad for p in params.values()))
                debug.assert_finite(loss, "train_step loss")
                debug.assert_finite([p.grad for p in params.values()],
                                    "train_step grads")
                grads = {}
                for k, p in params.items():
                    # one degenerate sample must not poison Adam's moments
                    g = torch.where(torch.isfinite(p.grad), p.grad, 0.0)
                    p.grad = g
                    grads[k] = g.clone()
                opt.step()
                with torch.no_grad():
                    for k, p in params.items():
                        if k in PARAM_BOUNDS:
                            p.clamp_(*PARAM_BOUNDS[k])
            return loss, grads

    return step
