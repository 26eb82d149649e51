"""LBVH build for hair segments (host numpy; ``yhair_tpu/accel/lbvh.py``).

Segments are ordered (longest-axis median splits, or Morton codes) and
packed into an implicit complete binary tree in heap order:

  * leaves hold K consecutive segments of that order,
  * node i (1-based heap) has children 2i and 2i + 1, no child pointers,
  * the stackless walk's skip index (escape to the next DFS node after
    the subtree) has a closed form: strip the trailing one-bits of i,
    then + 1,
  * boxes are computed bottom-up by level-reshaped min/max reductions.

The arithmetic is the reference's (float64 boxes and centroids, a stable
sort, uint32 shifts), so every array comes out bit-identical. The
cluster structure (``ops/clusters.py``) is this build's leaf level.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BVHArrays(NamedTuple):
    """Flat BVH, ready for upload.

    Heap layout, 1-based: nodes [1 .. 2 * n_leaves - 1]; leaves are the
    indices >= n_leaves. Index 0 is the walk's sentinel ("done").
    """

    node_min: np.ndarray   # (2L, 3) f32; row 0 unused; +inf empty boxes
    node_max: np.ndarray   # (2L, 3) f32; -inf likewise
    skip: np.ndarray       # (2L,) int32; 0 = done
    # ordered segment SoA, padded to L * K:
    p0: np.ndarray         # (L*K, 3) f32 (padding at 1e8)
    p1: np.ndarray
    r0: np.ndarray         # (L*K,) f32 (padding 0)
    r1: np.ndarray
    seg_index: np.ndarray  # (L*K,) int32 original segment id (-1 = pad)
    n_leaves: int
    leaf_size: int


def _expand_bits(v):
    """Spread 10 bits over 30 (3D Morton)."""
    v = v.astype(np.uint64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(x, y, z):
    """30-bit Morton code from [0, 1)^3 coordinates."""
    def q(a):
        return np.clip(a * 1024.0, 0, 1023).astype(np.uint64)
    return (_expand_bits(q(x)) << 2) | (_expand_bits(q(y)) << 1) \
        | _expand_bits(q(z))


def _skip_indices(n_total):
    """Closed-form escape index of every heap node.

    skip(i): j = i >> (number of trailing 1-bits of i); 0 if j <= 1,
    else j + 1. (Stripping trailing ones walks up while the node is a
    right child; the next DFS node is then the right sibling.)
    """
    i = np.arange(n_total, dtype=np.uint32)
    lowest_zero = ~i & (i + 1)          # power of two at the first 0 bit
    trailing_ones = np.zeros_like(i)
    lz = lowest_zero.copy()
    # log2 of a power of two by shifts (5 steps for 32 bits)
    for shift in (16, 8, 4, 2, 1):
        big = lz >= (np.uint32(1) << np.uint32(shift))
        trailing_ones = trailing_ones + np.where(big, shift, 0).astype(
            np.uint32)
        lz = np.where(big, lz >> np.uint32(shift), lz)
    j = i >> trailing_ones
    skip = np.where(j <= 1, 0, j + 1).astype(np.int32)
    skip[0] = 0
    return skip


def _median_split_order(centroid, n_leaves, K):
    """Recursive longest-axis median split into K-sized leaves.

    Each split puts exactly (n_lv // 2) * K elements left, so every
    subtree is a contiguous range and a heap node. Deterministic (stable
    sort by coordinate), so the native builder reproduces it with
    std::stable_sort. Returns the segment permutation (int32).
    """
    s = centroid.shape[0]
    order = np.arange(s, dtype=np.int64)
    stack = [(0, s, n_leaves)]
    while stack:
        lo, hi, n_lv = stack.pop()
        if n_lv <= 1 or hi - lo <= K:
            continue
        seg = order[lo:hi]
        c = centroid[seg]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        srt = np.argsort(c[:, ax], kind="stable")
        order[lo:hi] = seg[srt]
        left = min(hi - lo, (n_lv // 2) * K)
        stack.append((lo, lo + left, n_lv // 2))
        stack.append((lo + left, hi, n_lv - n_lv // 2))
    return order.astype(np.int32)


def build(p0, p1, r0, r1, leaf_size=4, method="median") -> BVHArrays:
    """(S, 3) endpoints and (S,) radii (any float) -> the LBVH. The leaf
    count rounds up to a power of two.

    method: "median" (longest-axis median splits: tighter leaf boxes)
    or "morton" (Morton-sorted runs).
    """
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    r0 = np.asarray(r0, np.float64)
    r1 = np.asarray(r1, np.float64)
    s = p0.shape[0]
    K = leaf_size

    # segment boxes: endpoint spheres
    bmin = np.minimum(p0 - r0[:, None], p1 - r1[:, None])
    bmax = np.maximum(p0 + r0[:, None], p1 + r1[:, None])
    centroid = 0.5 * (bmin + bmax)

    n_leaves = max(1, 1 << int(np.ceil(np.log2(max(1, (s + K - 1) // K)))))
    if method == "median":
        order = _median_split_order(centroid, n_leaves, K)
    elif method == "morton":
        lo = centroid.min(0)
        span = np.maximum(centroid.max(0) - lo, 1e-12)
        unit = (centroid - lo) / span
        codes = morton3(unit[:, 0], unit[:, 1], unit[:, 2])
        order = np.argsort(codes, kind="stable").astype(np.int32)
    else:
        raise ValueError(f"unknown method {method!r}")
    padded = n_leaves * K

    def gather_pad(a, fill):
        out = np.full((padded,) + a.shape[1:], fill, np.float32)
        out[:s] = a[order].astype(np.float32)
        return out

    seg_index = np.full(padded, -1, np.int32)
    seg_index[:s] = order
    # padding contributes +inf/-inf, so an all-padding leaf is empty
    lbmin = np.full((padded, 3), np.inf, np.float32)
    lbmax = np.full((padded, 3), -np.inf, np.float32)
    lbmin[:s] = bmin[order].astype(np.float32)
    lbmax[:s] = bmax[order].astype(np.float32)

    n_total = 2 * n_leaves
    node_min = np.full((n_total, 3), np.inf, np.float32)
    node_max = np.full((n_total, 3), -np.inf, np.float32)
    node_min[n_leaves:] = lbmin.reshape(n_leaves, K, 3).min(1)
    node_max[n_leaves:] = lbmax.reshape(n_leaves, K, 3).max(1)
    # bottom-up: the parents of level [lvl, 2 lvl)
    lvl = n_leaves
    while lvl > 1:
        node_min[lvl // 2:lvl] = node_min[lvl:2 * lvl].reshape(
            lvl // 2, 2, 3).min(1)
        node_max[lvl // 2:lvl] = node_max[lvl:2 * lvl].reshape(
            lvl // 2, 2, 3).max(1)
        lvl //= 2

    return BVHArrays(node_min=node_min, node_max=node_max,
                     skip=_skip_indices(n_total),
                     p0=gather_pad(p0, 1e8), p1=gather_pad(p1, 1e8),
                     r0=gather_pad(r0, 0.0), r1=gather_pad(r1, 0.0),
                     seg_index=seg_index, n_leaves=n_leaves, leaf_size=K)
