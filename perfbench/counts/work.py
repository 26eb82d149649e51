"""The work the two intersection kernels need for given inputs, and its
least time on a card: the count behind ``intersect_roofline``.

Inputs are what the harness captures at the program's search boundary
(``ops/intersect_kernel.nearest_hit(o, d, cl)`` and ``any_hit(o, d,
t_max, cl)``): the rays, the cluster boxes of ``cl`` (``cmin``,
``cmax``) and the search's answer (t, or the occlusion flags). Whatever
implements the lists or the kernels, the same inputs give the same
count.

Per 128-ray block (rays in the order given), a cluster is *listed*
when some ray of the block enters its box (slab test, entry distance
tn >= T_MIN) at tn <= that ray's limit:

- nearest: the limit is the ray's answer t (1e30 on a miss), so the
  listed clusters are the ones an exact search has to test: every
  listed cluster costs its 128 x 128 ray-segment tests.
- any: the limit is the ray's t_max for a ray the search found
  unoccluded (its answer), and no cluster for an occluded one: proving a
  ray unoccluded takes every cluster it enters, and finding an occluder
  may take as little as one (so a block of occluded rays costs at least
  one visit). Each visit costs 128 x 128 tests.

Both are the least work of an exact block search over these clusters,
so the share of the roofline they give cannot pass 100%.

FP32 operations of one ray-segment test, recounted from the closest-
approach capsule test (``_segment_test``; each multiply, add, subtract,
divide, minimum, maximum and comparison is one operation; the kernels
are built without FMA contraction):

    w0 = o - p0                                  3
    b = d.d2, dd = d.w0, e = d2.w0               3 x 5 = 15
    denom = max(|d2|^2 - b*b, 1e-12)             3
    u = clamp((e - b*dd) / denom, 0, 1)          5
    s = b*u - dd                                 2
    off = (o + s*d) - (p0 + u*d2)                3 x 5 = 15
    dist2 = off.off                              5
    r = r0 + dr*u                                2
    dist2 <= r*r, s > T_MIN, s <= t_cap          4
                                                 --
                                                 54

The nearest search adds one comparison per test for its running
minimum (55); the any search's OR is an integer operation (54).
Bytes: each input read once and each output written once: the rays
(o, d: 24 bytes; t_max: 4 more), one 16 x 128 float32 tile of each
cluster tested at least once, and the outputs (t and index: 8 bytes;
the occlusion flag: 4).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..reference.search import INF, inverse_dir, slab

BLOCK = 128
TESTS_PER_VISIT = BLOCK * BLOCK
OPS_PER_TEST = {"hit": 55, "any": 54}
TILE_BYTES = 16 * BLOCK * 4
RAY_CHUNK = 8192


def peaks(device_name: str):
    """(FP32 operations/s, bytes/s) of the card, from peaks.json."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    for key, row in table.items():
        if key in device_name:
            return row["fp32_flop_s"], row["hbm_bytes_s"]
    return None


def _lists(o, d, cl, limit):
    """(block membership (nb, C) bool, block key (nb, C)) of the clusters
    whose box some ray of the block enters at tn <= its limit."""
    inv = inverse_dir(d)
    member, key = [], []
    for lo in range(0, o.shape[0], RAY_CHUNK):
        sl = slice(lo, lo + RAY_CHUNK)
        tn, hit = slab(o[sl], inv[sl], cl.cmin, cl.cmax)
        hit = hit & (tn <= limit[sl, None])
        c = tn.shape[1]
        member.append(hit.view(-1, BLOCK, c).any(1))
        key.append(torch.where(hit, tn, INF).view(-1, BLOCK, c).amin(1))
    return torch.cat(member), torch.cat(key)


def hit_work(o, d, t, cl):
    """(tests, bytes) an exact nearest search of these rays needs."""
    member, _ = _lists(o, d, cl, torch.where(t < INF, t, INF))
    visits = int(member.sum())
    tiles = int(member.any(0).sum())
    n = o.shape[0]
    return visits * TESTS_PER_VISIT, n * 24 + n * 8 + tiles * TILE_BYTES


def any_work(o, d, t_max, occ, cl):
    """(tests, bytes) that settling these rays' occlusion needs: each
    block visits at least every cluster an unoccluded ray of it enters
    (nothing less proves that ray unoccluded), and at least one cluster
    where all its rays are occluded."""
    member, _ = _lists(o, d, cl, torch.where(occ, -1.0, t_max))
    visits = member.sum(1)
    some = occ.view(-1, BLOCK).any(1)
    visits = torch.where((visits == 0) & some, 1, visits)
    tiles = int(member.any(0).sum())
    n = o.shape[0]
    return (int(visits.sum()) * TESTS_PER_VISIT,
            n * 28 + n * 4 + tiles * TILE_BYTES)


def least_seconds(kind, tests, n_bytes, flop_s, bytes_s):
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory's rate."""
    return max(tests * OPS_PER_TEST[kind] / flop_s, n_bytes / bytes_s)

