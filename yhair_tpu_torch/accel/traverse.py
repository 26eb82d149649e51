"""Stackless BVH walk (skip pointers; ``yhair_tpu/accel/traverse.py``).

Every ray carries one node pointer through the DFS of the implicit heap
tree that ``accel/lbvh.py`` builds:

    internal hit  -> first child (2 * node)
    internal miss -> skip[node]   (escape past the subtree)
    leaf          -> test its K segments, then skip[node]

The reference steps every ray in one ``lax.while_loop`` until each
pointer reaches the 0 sentinel. Here the loop is torch ops (the
reference's is plain XLA, not a Pallas kernel). Two things differ, and
neither changes a ray's result: the state is compacted to the rays still
walking every ``check`` steps (extra steps of a finished ray do
nothing), and the test whether any ray walks, a host sync, runs only
then: every step on the CPU, every 16 steps on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import segments as seg

INF = 1e30
# steps between the live-ray compactions (each a host sync)
CHECK_EVERY_CPU, CHECK_EVERY_CUDA = 1, 16


class DeviceBVH(NamedTuple):
    node_min: torch.Tensor   # (2L, 3) f32
    node_max: torch.Tensor   # (2L, 3) f32
    skip: torch.Tensor       # (2L,) int64
    p0: torch.Tensor         # (L*K, 3) ordered, padded (at 1e8)
    p1: torch.Tensor
    r0: torch.Tensor         # (L*K,)
    r1: torch.Tensor
    seg_index: torch.Tensor  # (L*K,) int32, -1 = padding
    n_leaves: int
    leaf_size: int

    @classmethod
    def from_host(cls, b, device="cpu"):
        """From ``lbvh.BVHArrays`` onto ``device``."""
        def t(a):
            return torch.as_tensor(a, device=device)
        return cls(t(b.node_min), t(b.node_max), t(b.skip).long(),
                   t(b.p0), t(b.p1), t(b.r0), t(b.r1), t(b.seg_index),
                   int(b.n_leaves), int(b.leaf_size))

    def to(self, device):
        return self._replace(**{k: getattr(self, k).to(device) for k in (
            "node_min", "node_max", "skip", "p0", "p1", "r0", "r1",
            "seg_index")})

    # the integrator's searches (``scene.accel``)
    def nearest(self, o, d):
        return make_nearest_fn(self)(o, d)

    occluded, winners = seg.Scan.occluded, seg.Scan.winners
    sort_box = seg.Scan.sort_box


def _dot(a, b):
    """Sum over the last axis (3) in the reference's order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _seg_hit(o, d, p0, p1, r0, r1, t_min):
    """Closest approach of rays (n, 1, 3) to segments (n, K, 3) ->
    (hit before the ray's current best aside, s), each (n, K): the
    reference's ``_seg_hit`` arithmetic, whose ``s < t_best`` test the
    caller applies leaf slot by slot."""
    d2 = p1 - p0
    w0 = o - p0
    b = _dot(d, d2)
    c = _dot(d2, d2)
    dd = _dot(d, w0)
    e = _dot(d2, w0)
    denom = torch.clamp(c - b * b, min=1e-12)
    u = torch.clamp((e - b * dd) / denom, 0.0, 1.0)
    s = b * u - dd
    off = w0 + s[..., None] * d - u[..., None] * d2
    dist2 = _dot(off, off)
    r = r0 + (r1 - r0) * u
    return (dist2 <= r * r) & (s > t_min), s


def _step(o, d, inv_d, node, t_best, idx, bvh: DeviceBVH, t_min, slots):
    """One lockstep walk step of (n,) pointers -> (node, t_best, idx).
    slots: arange(leaf_size)."""
    K = bvh.leaf_size
    active = node != 0
    node_safe = torch.clamp(node, min=1)
    t0 = (bvh.node_min[node_safe] - o) * inv_d
    t1 = (bvh.node_max[node_safe] - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    box_hit = (tnear <= tfar) & (tfar > t_min) & (tnear < t_best)

    is_leaf = node_safe >= bvh.n_leaves
    do_leaf = active & is_leaf & box_hit
    first = torch.where(is_leaf, node_safe - bvh.n_leaves, 0) * K
    sidx = first[:, None] + slots                 # (n, K)
    ok, s = _seg_hit(o[:, None], d[:, None], bvh.p0[sidx], bvh.p1[sidx],
                     bvh.r0[sidx], bvh.r1[sidx], t_min)
    ok = ok & do_leaf[:, None]
    for k in range(K):       # in slot order: a strict s < t_best
        upd = ok[:, k] & (s[:, k] < t_best)
        t_best = torch.where(upd, s[:, k], t_best)
        idx = torch.where(upd, sidx[:, k], idx)

    descend = box_hit & ~is_leaf
    nxt = torch.where(descend, 2 * node_safe, bvh.skip[node_safe])
    return torch.where(active, nxt, 0), t_best, idx


def nearest_hit(o, d, bvh: DeviceBVH, t_min=1e-4, t_max=INF,
                max_iters=None, stats=None):
    """Closest hit. o, d: (N, 3) -> (t, idx into the ordered segments
    (int32), hit, original segment id (0 where missed)).

    stats: a dict that gets the walk's ``steps`` (lockstep iterations)
    and ``ray_steps`` (steps times the rays stepped: those still in the
    compacted set, so up to ``check`` - 1 idle steps of a ray that
    finished between checks) added.
    """
    n, dev = o.shape[0], o.device
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12,
                              torch.where(d < 0, -1e-12, 1e-12), d)
    t_cap = torch.clamp(torch.as_tensor(t_max, dtype=o.dtype, device=dev)
                        .expand(n), max=INF).contiguous()
    if max_iters is None:
        # worst case: the full DFS of 2L nodes; in practice far fewer
        max_iters = 4 * bvh.n_leaves + 64
    check = CHECK_EVERY_CUDA if dev.type == "cuda" else CHECK_EVERY_CPU

    slots = torch.arange(bvh.leaf_size, device=dev)
    t_out = t_cap.clone()
    idx_out = torch.zeros(n, dtype=torch.int64, device=dev)
    rays = torch.arange(n, device=dev)       # the rays still walking
    lo, ld, linv = o, d, inv_d
    lt, lidx = t_cap, idx_out.clone()
    node = torch.ones(n, dtype=torch.int64, device=dev)
    it = 0
    while rays.numel() and it < max_iters:
        steps = min(check, max_iters - it)
        if stats is not None:
            stats["ray_steps"] = stats.get("ray_steps", 0) \
                + rays.numel() * steps
        for _ in range(steps):
            node, lt, lidx = _step(lo, ld, linv, node, lt, lidx, bvh,
                                   t_min, slots)
        it += steps
        done = node == 0
        t_out[rays[done]] = lt[done]
        idx_out[rays[done]] = lidx[done]
        keep = ~done
        rays, node = rays[keep], node[keep]
        lo, ld, linv, lt, lidx = lo[keep], ld[keep], linv[keep], lt[keep], \
            lidx[keep]
    # rays cut by max_iters keep what they found
    t_out[rays] = lt
    idx_out[rays] = lidx
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + it
    hit = t_out < t_cap
    orig = torch.where(hit, bvh.seg_index[idx_out], 0)
    return torch.where(hit, t_out, INF), idx_out.to(torch.int32), hit, orig


def make_nearest_fn(bvh: DeviceBVH, reordered_segments=None):
    """fn(o, d) -> (t, idx into the ordered segments, hit), which
    ``DeviceBVH.nearest`` calls for the integrator. Its shading then
    gathers the BVH's ordered segments (``reordered_segments``, kept for
    the reference's signature)."""
    def fn(o, d):
        t, idx, hit, _ = nearest_hit(o, d, bvh)
        return t, idx, hit
    return fn
