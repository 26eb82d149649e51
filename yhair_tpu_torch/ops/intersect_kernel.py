"""Ray - segment intersection over the cluster structure
(``yhair_tpu/ops/intersect_kernel.py``).

Phase 1 (CUDA, ``csrc/intersect.cu:lists_kernel``): slab-test every ray
against every cluster AABB, reduce to a per-128-ray-block cluster mask
and sort each block's hit clusters front to back into an id list +
count, in one launch.
Phase 2 (CUDA, ``csrc/intersect.cu``): each list is cut into work items
of CHUNK consecutive clusters (``_work_items``), which a persistent grid
takes from a counter; an item tests its block's rays against its
clusters' segments. The hit kernel merges a block's items in item order.

Two searches share the segment test:
  * ``nearest_hit``: closest hit (t, segment index, hit mask);
  * ``any_hit``: occlusion with a per-ray t_max.
Both run two passes: a short front-to-back prefix, then the rest of the
list pruned by what the prefix found (see each docstring).

Kernel wrappers (``_block_cluster_lists``, ``hit_pass``, ``any_pass``)
launch the CUDA kernel for CUDA tensors and raise if they cannot; for CPU
tensors they run the plain torch versions (``_block_cluster_lists_plain``,
``hit_pass_plain``, ``any_pass_plain``), which repeat the kernels'
arithmetic. ``LAUNCHES`` (``kernels.LAUNCHES``) counts each launch.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..device import resolve_device
from ..utils import trace
from .clusters import Clusters

F32, I32 = torch.float32, torch.int32

INF = 1e30
NO_ID = 3.4e38
T_MIN = 1e-4
BLOCK = 128
# per-block list capacity: the cluster count rounded up to whole 128-id
# rows, at most MAX_IDS; longer lists are sent as the "scan all" sentinel
MAX_IDS = 2048
# front-to-back prefix lengths of the two-pass searches
K_PREFIX = 64
K_ANY_PREFIX = 16
# clusters per work item of the kernels (chosen by timing the bench
# strip's launches on an H100 at other values: PERF.md)
CHUNK = 4
# rays per chunk of the plain phase 1: (chunk, C) temporaries of 32 MB at
# C = 1024
RAY_CHUNK = 64 * BLOCK
# dynamic shared memory a lists_kernel CTA may take for its sort buffer
# and keys (_lists_block_bytes); past it (C > 16,384) the kernel works in
# a per-block slice of a global scratch tensor
LISTS_SMEM = 200 * 1024
LAUNCHES = kernels.LAUNCHES


def _k_cap(c):
    return min(((c + 127) // 128) * 128, MAX_IDS)


# ---------------------------------------------------------------------------
# phase 1: per-block cluster lists


def _block_cluster_lists(o, d, cl: Clusters, t_max=None, exclude_below=None,
                         return_key=False):
    """Per-block front-to-back hit-cluster ids and counts.

    o, d: (N, 3) float32, N % 128 == 0. t_max (N,): a cluster counts for a
    ray only when its entry distance tn lies in [T_MIN, t_max].
    exclude_below (nb,): drop clusters whose block entry distance is
    strictly below it (a prefix pass already visited them).
    -> (ids (nb, C) int32, counts (nb,) int32[, key (nb, C)]); key is the
    sort key: the block's entry distance, +INF for clusters it misses; ids
    are the clusters in the order of a stable argsort of key.

    CUDA tensors: one ``lists_kernel`` launch; CPU tensors:
    ``_block_cluster_lists_plain``. Both take only contiguous float32
    inputs on the rays' device, and raise ValueError on others.
    """
    with trace.span("yhair.lists"):
        nb, c = o.shape[0] // BLOCK, cl.n_clusters
        kernels.check(BLOCK, o, d, (cl.cmin, F32, (c, 3)),
                      (cl.cmax, F32, (c, 3)), (t_max, F32, (o.shape[0],)),
                      (exclude_below, F32, (nb,)))
        if o.device.type == "cpu":
            return _block_cluster_lists_plain(o, d, cl, t_max, exclude_below,
                                              return_key)
        ids = torch.empty((nb, c), dtype=torch.int32, device=o.device)
        counts = torch.empty(nb, dtype=torch.int32, device=o.device)
        key = (torch.empty((nb, c), dtype=torch.float32, device=o.device)
               if return_key else None)
        per_block = _lists_block_bytes(c)
        scratch = (torch.empty(nb * per_block // 8, dtype=torch.int64,
                               device=o.device)
                   if per_block > LISTS_SMEM else None)
        kernels.launch("yhair_block_lists", o, d, cl.cmin, cl.cmax, t_max,
                       exclude_below, nb, c, _sort_cap(c), scratch, ids,
                       counts, key)
        return (ids, counts, key) if return_key else (ids, counts)


def _block_cluster_lists_plain(o, d, cl: Clusters, t_max=None,
                               exclude_below=None, return_key=False):
    """Torch twin of ``lists_kernel``: ``_block_cluster_lists`` in torch
    ops over chunks of RAY_CHUNK rays."""
    n, c = o.shape[0], cl.n_clusters
    small = torch.where(d < 0, -1e-12, 1e-12).to(d.dtype)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, small, d)
    block_hit, tn_block = [], []
    for lo in range(0, n, RAY_CHUNK):
        oc, invc = o[lo:lo + RAY_CHUNK], inv[lo:lo + RAY_CHUNK]
        m = oc.shape[0]
        tn = torch.full((m, c), T_MIN, dtype=o.dtype, device=o.device)
        tf = torch.full((m, c), INF, dtype=o.dtype, device=o.device)
        for ax in range(3):
            t0 = ((cl.cmin[None, :, ax] - oc[:, ax, None])
                  * invc[:, ax, None])
            t1 = ((cl.cmax[None, :, ax] - oc[:, ax, None])
                  * invc[:, ax, None])
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        hit = tn <= tf
        if t_max is not None:
            hit = hit & (tn <= t_max[lo:lo + RAY_CHUNK, None])
        block_hit.append(hit.view(-1, BLOCK, c).any(1))
        tn_block.append(torch.where(hit, tn, INF).view(-1, BLOCK, c)
                        .amin(1))
    block_hit = torch.cat(block_hit)
    tn_block = torch.cat(tn_block)
    if exclude_below is not None:
        block_hit = block_hit & ~(tn_block < exclude_below[:, None])
    counts = block_hit.sum(1).to(torch.int32)
    key = torch.where(block_hit, tn_block, INF)
    # stable, as jnp.argsort: ties keep cluster order
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    if return_key:
        return order, counts, key
    return order, counts


def _sort_cap(c):
    """lists_kernel's sort buffer: the next power of two >= C pairs."""
    return 1 << max(c - 1, 0).bit_length()


def _lists_block_bytes(c):
    """A lists_kernel block's sort buffer and C key bit patterns, in
    bytes (a multiple of 8)."""
    return 8 * (_sort_cap(c) + (c + 1) // 2)


def _visited_threshold(key, ids, counts, n_visited):
    """Per-block entry distance under which a prefix pass over the first
    min(counts, n_visited) list entries visited every cluster: the key of
    the last visited entry; -inf where the prefix visited nothing."""
    n_vis = torch.clamp(counts, max=n_visited)
    last = torch.gather(ids, 1, torch.clamp(n_vis - 1, min=0)[:, None]
                        .long())
    thresh = torch.gather(key, 1, last.long())[:, 0]
    return torch.where(n_vis > 0, thresh, -torch.inf)


def _pack_lists(ids, counts, k_cap, n_clusters):
    """The kernels' list layout: ids as a contiguous (nb, k_cap) int32
    array (zero-padded or cut), counts > k_cap as the sentinel C ("scan
    every cluster")."""
    nb, width = ids.shape
    if width < k_cap:
        ids = torch.cat([ids, ids.new_zeros((nb, k_cap - width))], 1)
    ids = ids[:, :k_cap].to(torch.int32).contiguous()
    counts = torch.where(counts > k_cap, n_clusters, counts)
    return ids, counts.to(torch.int32).contiguous()


def _work_items(counts, chunk):
    """The kernels' work items: block b's list of counts[b] visits (the
    packed counts, C for the sentinel) is cut into ceil(counts[b] /
    chunk) items of chunk consecutive positions. -> the inclusive prefix
    sum of items per block, (nb,) int32; item q belongs to the first
    block whose sum exceeds q."""
    return torch.cumsum(torch.div(counts + (chunk - 1), chunk,
                                  rounding_mode="floor"), 0,
                        dtype=torch.int32)


# ---------------------------------------------------------------------------
# phase 2: plain versions of the kernels (same inputs, same arithmetic)


def _segment_test(o, d, tile, t_cap):
    """The kernels' closest-approach capsule test.

    o, d: (nb, 128, 1, 3) rays; tile: (nb, 1, 16, 128) cluster tiles;
    t_cap: (nb, 128, 1). -> (ok, s) of shape (nb, 128 rays, 128 segs).
    """
    p0 = [tile[:, :, ax, :] for ax in range(3)]
    r0, dr, c_seg = tile[:, :, 3, :], tile[:, :, 7, :], tile[:, :, 8, :]
    d2 = [tile[:, :, 4 + ax, :] for ax in range(3)]
    oa = [o[..., ax] for ax in range(3)]
    da = [d[..., ax] for ax in range(3)]
    w0 = [oa[ax] - p0[ax] for ax in range(3)]
    B = da[0] * d2[0] + da[1] * d2[1] + da[2] * d2[2]
    dd = da[0] * w0[0] + da[1] * w0[1] + da[2] * w0[2]
    e = d2[0] * w0[0] + d2[1] * w0[1] + d2[2] * w0[2]
    denom = torch.clamp(c_seg - B * B, min=1e-12)
    u = torch.clamp((e - B * dd) / denom, 0.0, 1.0)
    s = B * u - dd
    off = [(oa[ax] + s * da[ax]) - (p0[ax] + u * d2[ax]) for ax in range(3)]
    dist2 = off[0] * off[0] + off[1] * off[1] + off[2] * off[2]
    r = r0 + dr * u
    ok = (dist2 <= r * r) & (s > T_MIN) & (s <= t_cap)
    return ok, s


def _visits(ids, counts, k_cap):
    """Yield (j, cid (nb,), valid (nb,)) over list positions
    j < max(counts); the sentinel scans every cluster in order."""
    use_all = counts > k_cap
    n_max = int(counts.max()) if counts.numel() else 0
    for j in range(n_max):
        cid = torch.where(use_all, j, ids[:, min(j, k_cap - 1)])
        yield j, cid.long(), j < counts


def hit_pass_plain(o, d, seeds, ids, counts, tc, k_cap):
    """Torch twin of the CUDA hit kernel on the packed inputs: per ray the
    lexicographic min of (t, original id) over the block's listed
    clusters (candidates s <= the pass seed t), merged with the seeds.
    -> (t, idx = cid * 128 + lane, oid), each (N,)."""
    best = _hit_best_plain(o, d, seeds[0], ids, counts, tc, k_cap)
    return _merge_seeds(best, seeds)


def _hit_best_plain(o, d, t_cap, ids, counts, tc, k_cap):
    """The unseeded part of ``hit_pass_plain``: per ray the lexicographic
    min of (t, original id) over the listed clusters, candidates
    T_MIN < s <= t_cap; (INF, NO_ID) where there is none. Ties, which
    only padding lanes can make, go to the earlier (position, lane).
    -> (t, idx, oid), each (N,)."""
    n = o.shape[0]
    nb = n // BLOCK
    ob, db = o.reshape(nb, BLOCK, 1, 3), d.reshape(nb, BLOCK, 1, 3)
    t_seed = t_cap.reshape(nb, BLOCK, 1)
    best_t = torch.full((nb, BLOCK), INF, dtype=o.dtype, device=o.device)
    best_oid = torch.full_like(best_t, NO_ID)
    best_idx = torch.zeros((nb, BLOCK), dtype=torch.int32, device=o.device)
    for _, cid, valid in _visits(ids, counts, k_cap):
        tile = tc[cid][:, None]                          # (nb, 1, 16, 128)
        ok, s = _segment_test(ob, db, tile, t_seed)
        ok = ok & valid[:, None, None]
        s_m = torch.where(ok, s, INF)
        t_j = s_m.amin(-1)
        oid = tile[:, :, 9, :].expand_as(s_m)
        oid_m = torch.where(ok & (s_m == t_j[..., None]), oid, NO_ID)
        oid_j, lane_j = oid_m.min(-1)
        better = ok.any(-1) & ((t_j < best_t)
                               | ((t_j == best_t) & (oid_j < best_oid)))
        best_t = torch.where(better, t_j, best_t)
        best_oid = torch.where(better, oid_j, best_oid)
        idx_j = (cid[:, None] * BLOCK + lane_j).to(torch.int32)
        best_idx = torch.where(better, idx_j, best_idx)
    return tuple(x.reshape(n) for x in (best_t, best_idx, best_oid))


def _merge_seeds(best, seeds):
    """The pass seeds merged into an unseeded result."""
    best_t, best_idx, best_oid = best
    t0, i0, oid0 = seeds
    has = best_t < INF
    better = (best_t < t0) | (has & (best_t == t0) & (best_oid < oid0))
    return (torch.where(better, best_t, t0),
            torch.where(better, best_idx, i0),
            torch.where(better, best_oid, oid0))


def any_pass_plain(o, d, t_cap, ids, counts, tc, k_cap,
                   return_visits=False):
    """Torch twin of the CUDA any kernel: 1 where some listed segment has
    T_MIN < s <= t_cap, else 0. -> (N,) int32.

    return_visits: also return (nb,) int32, the visits a sequential
    front-to-back walk of each block needs: up to and including the one
    after which all its rays are dark (the work the bound counts)."""
    n = o.shape[0]
    nb = n // BLOCK
    ob, db = o.reshape(nb, BLOCK, 1, 3), d.reshape(nb, BLOCK, 1, 3)
    cap = t_cap.reshape(nb, BLOCK, 1)
    occ = torch.zeros((nb, BLOCK), dtype=torch.bool, device=o.device)
    visits = torch.zeros(nb, dtype=torch.int32, device=o.device)
    for _, cid, valid in _visits(ids, counts, k_cap):
        visits += (valid & ~occ.all(1)).to(torch.int32)
        ok, _ = _segment_test(ob, db, tc[cid][:, None], cap)
        occ = occ | (ok.any(-1) & valid[:, None])
    occ = occ.reshape(n).to(torch.int32)
    return (occ, visits) if return_visits else occ


# ---------------------------------------------------------------------------
# kernel wrappers


def hit_pass(o, d, seeds, ids, counts, tc, k_cap):
    """One nearest-hit pass (the TPU's ``_hit_pass``).

    o, d: (N, 3) f32; seeds: (t0 f32, i0 int32, oid0 f32), each (N,);
    ids: (nb, L) cluster lists; counts: (nb,); tc: (C, 16, 128) tiles;
    k_cap: list capacity. -> (t, idx, oid), each (N,).
    """
    ids, counts = _pack_lists(ids, counts, k_cap, tc.shape[0])
    if o.device.type == "cpu":
        return hit_pass_plain(o, d, seeds, ids, counts, tc, k_cap)
    n, nb = o.shape[0], o.shape[0] // BLOCK
    t0, i0, oid0 = (x.contiguous() for x in seeds)
    kernels.check(BLOCK, o, d, (t0, F32, (n,)), (i0, I32, (n,)),
                  (oid0, F32, (n,)), (ids, I32, (nb, k_cap)),
                  (counts, I32, (nb,)), (tc, F32, (tc.shape[0], 16, BLOCK)))
    prefix = _work_items(counts, CHUNK)
    # per-item partials (t, oid, idx) for as many items as the packed
    # counts allow (each <= max(k_cap, C)), sized without a host sync:
    # 201 MB at the bench shapes, of which a launch writes under 5%
    max_items = nb * -(-max(k_cap, tc.shape[0]) // CHUNK)
    partials = torch.empty(3 * max_items * BLOCK, dtype=torch.float32,
                           device=o.device)
    scratch = torch.empty(1, dtype=torch.int32, device=o.device)
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    idx = torch.empty(n, dtype=torch.int32, device=o.device)
    oid = torch.empty(n, dtype=torch.float32, device=o.device)
    kernels.launch("yhair_hit_pass", o, d, t0, i0, oid0, ids, counts, prefix,
                   tc, nb, k_cap, CHUNK, max_items, scratch, partials,
                   t, idx, oid)
    return t, idx, oid


def any_pass(o, d, t_cap, ids, counts, tc, k_cap, visits=None):
    """One occlusion pass (the TPU's ``any_hit.run_pass``).

    t_cap: (N,) f32. -> occ (N,) int32. visits: optional (nb,) int32
    output of the clusters each block's work items visited before they
    stopped (CUDA only: the work the launch did, which may exceed what a
    sequential walk needs; ``any_pass_plain`` counts that).
    """
    ids, counts = _pack_lists(ids, counts, k_cap, tc.shape[0])
    if o.device.type == "cpu":
        return any_pass_plain(o, d, t_cap, ids, counts, tc, k_cap)
    n, nb = o.shape[0], o.shape[0] // BLOCK
    t_cap = t_cap.contiguous()
    kernels.check(BLOCK, o, d, (t_cap, F32, (n,)), (ids, I32, (nb, k_cap)),
                  (counts, I32, (nb,)), (tc, F32, (tc.shape[0], 16, BLOCK)),
                  (visits, I32, (nb,)))
    prefix = _work_items(counts, CHUNK)
    scratch = torch.empty(1, dtype=torch.int32, device=o.device)
    occ = torch.empty(n, dtype=torch.int32, device=o.device)
    kernels.launch("yhair_any_pass", o, d, t_cap, ids, counts, prefix, tc,
                   nb, k_cap, CHUNK, scratch, occ, visits)
    return occ


# ---------------------------------------------------------------------------
# two-pass searches


def nearest_hit(o, d, cl: Clusters):
    """Closest hit for a ray batch. o, d: (N, 3), N % 128 == 0.

    -> (t, idx, hit): idx indexes the cluster-ordered segments
    (cl.s0/s1 rows). Pass 1 visits only the K_PREFIX front-to-back
    clusters of each block, which resolves most rays and gives a per-ray
    bound t1; pass 2 rebuilds the lists pruned by t_max = t1 (a hit at
    t <= t1 lies in a cluster entered at tn <= t), drops the clusters
    pass 1 visited, and finishes from pass 1's seeds. The (t, id)
    winner is the same as one full pass.
    """
    n, c = o.shape[0], cl.n_clusters
    k_cap = _k_cap(c)
    k_prefix = min(K_PREFIX, k_cap)
    ids, counts, key1 = _block_cluster_lists(o, d, cl, return_key=True)
    seeds = (torch.full((n,), INF, dtype=torch.float32, device=o.device),
             torch.zeros((n,), dtype=torch.int32, device=o.device),
             torch.full((n,), NO_ID, dtype=torch.float32, device=o.device))
    if c <= k_prefix:
        t, idx, _ = hit_pass(o, d, seeds, ids, counts, cl.tc, k_cap)
    else:
        t1, i1, oid1 = hit_pass(o, d, seeds, ids[:, :k_prefix],
                                torch.clamp(counts, max=k_prefix), cl.tc,
                                max(128, k_prefix))
        thresh = _visited_threshold(key1, ids, counts, k_prefix)
        ids2, counts2 = _block_cluster_lists(o, d, cl, t_max=t1,
                                             exclude_below=thresh)
        t, idx, _ = hit_pass(o, d, (t1, i1, oid1), ids2, counts2, cl.tc,
                             k_cap)
    hit = t < INF
    return torch.where(hit, t, INF), idx, hit


def any_hit(o, d, t_max, cl: Clusters):
    """Occlusion: True where some segment lies in (T_MIN, t_max].

    Pass A scans a K_ANY_PREFIX prefix of each block's list. Pass B
    neutralises the rays pass A resolved (t_max = 0, below T_MIN, so they
    add nothing to any block's list or test), drops the clusters pass A
    visited, and scans what is left for the stragglers.
    """
    c = cl.n_clusters
    k_cap = _k_cap(c)
    ids, counts, key1 = _block_cluster_lists(o, d, cl, t_max=t_max,
                                             return_key=True)
    if c <= K_ANY_PREFIX:
        return any_pass(o, d, t_max, ids, counts, cl.tc, k_cap) > 0
    occ_a = any_pass(o, d, t_max, ids[:, :K_ANY_PREFIX],
                     torch.clamp(counts, max=K_ANY_PREFIX), cl.tc, 128) > 0
    # a block whose list fit in the prefix is fully resolved
    done_ray = (counts <= K_ANY_PREFIX).repeat_interleave(BLOCK) | occ_a
    tmax_b = torch.where(done_ray, 0.0, t_max)
    thresh = _visited_threshold(key1, ids, counts, K_ANY_PREFIX)
    ids_b, counts_b = _block_cluster_lists(o, d, cl, t_max=tmax_b,
                                           exclude_below=thresh)
    occ_b = any_pass(o, d, tmax_b, ids_b, counts_b, cl.tc, k_cap) > 0
    return occ_a | occ_b


def _pad_rays(o, d, extra=None):
    """Pad a batch to a multiple of 128 with far-away rays (t_max 0)."""
    n = o.shape[0]
    pad = (-n) % BLOCK
    if pad:
        o = torch.cat([o, o.new_full((pad, 3), 1e8)])
        d = torch.cat([d, d.new_ones((pad, 3))])
        if extra is not None:
            extra = torch.cat([extra, extra.new_zeros((pad,))])
    return o.contiguous(), d.contiguous(), extra, n


def make_nearest_fn(cl: Clusters, device=None):
    """fn(o, d) -> (t, idx, hit) over the clusters, any batch size."""
    dev = resolve_device(device)
    cl = cl.to(dev)

    def fn(o, d):
        o, d, _, n = _pad_rays(o.to(dev), d.to(dev))
        t, idx, hit = nearest_hit(o, d, cl)
        return t[:n], idx[:n], hit[:n]
    return fn


def make_occluded_fn(cl: Clusters, device=None):
    """fn(o, d, t_max) -> occluded (N,) bool, any batch size."""
    dev = resolve_device(device)
    cl = cl.to(dev)

    def fn(o, d, t_max):
        o, d, t_max, n = _pad_rays(o.to(dev), d.to(dev), t_max.to(dev))
        return any_hit(o, d, t_max.contiguous(), cl)[:n]
    return fn
