"""Median-split leaf order and leaf boxes for hair segments (host numpy).

The port's own copy of the leaf level of ``yhair_tpu/accel/lbvh.py:build``
(method "median"): the cluster structure needs only the leaves, so the
internal heap levels and skip indices of the reference are not built.
The arithmetic is the reference's, so the leaves come out bit-identical.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Leaves(NamedTuple):
    leaf_min: np.ndarray   # (L, 3) f32; +inf rows for all-padding leaves
    leaf_max: np.ndarray   # (L, 3) f32; -inf rows likewise
    # median-split-ordered segment SoA, padded to L*K:
    p0: np.ndarray         # (L*K, 3) f32 (padding at 1e8)
    p1: np.ndarray
    r0: np.ndarray         # (L*K,) f32 (padding 0)
    r1: np.ndarray
    seg_index: np.ndarray  # (L*K,) int32 original segment id (-1 = pad)
    n_leaves: int
    leaf_size: int


def _median_split_order(centroid, n_leaves, K):
    """Recursive longest-axis median split into K-sized leaves.

    Each split puts exactly (n_lv // 2) * K elements left, so every
    subtree is a contiguous range. Deterministic (stable sort by
    coordinate). Returns the segment permutation (int32).
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


def build_leaves(p0, p1, r0, r1, leaf_size=128) -> Leaves:
    """(S, 3) endpoints and (S,) radii -> median-split leaves. The leaf
    count rounds up to a power of two."""
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
    order = _median_split_order(centroid, n_leaves, K)
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
    return Leaves(leaf_min=lbmin.reshape(n_leaves, K, 3).min(1),
                  leaf_max=lbmax.reshape(n_leaves, K, 3).max(1),
                  p0=gather_pad(p0, 1e8), p1=gather_pad(p1, 1e8),
                  r0=gather_pad(r0, 0.0), r1=gather_pad(r1, 0.0),
                  seg_index=seg_index, n_leaves=n_leaves, leaf_size=K)
