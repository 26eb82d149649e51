"""Cluster acceleration structure (``yhair_tpu/ops/clusters.py``).

Segments are median-split ordered (by the native C++ builder where it
can be had, else by numpy) and packed into clusters of 128; each
cluster has an AABB and a precomputed (16, 128) tile that the CUDA
kernels read. The hairball's 120k segments give C = 1024 clusters and an
8 MB tile array, which stays in the H100's 50 MB L2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel import lbvh, native
from ..geometry import segments as seg

CLUSTER_SIZE = 128


def _tiles(s0, s1, seg_index, n_clusters, k):
    """(C, 16, k) tiles from the (S, 4) endpoint SoA.

    Rows: p0.xyz, r0, d2.xyz (= p1 - p0), dr (= r1 - r0), |d2|^2, original
    segment id as f32 (exact below 2^24; the (t, id) tie-break key;
    padding lanes get 3e30 so they lose ties), then 6 zero rows.
    """
    assert s0.shape[0] < (1 << 24), "f32 tie-break ids need S < 2^24"
    a0 = s0.reshape(n_clusters, k, 4).transpose(0, 2, 1)   # (C, 4, k)
    a1 = s1.reshape(n_clusters, k, 4).transpose(0, 2, 1)
    p0 = a0[:, :3]
    d2 = a1[:, :3] - p0
    c_seg = (d2 * d2).sum(1, keepdims=True)
    oid = np.where(seg_index < 0, np.float32(3e30),
                   seg_index.astype(np.float32))
    oid = oid.reshape(n_clusters, 1, k)
    tc = np.concatenate([p0, a0[:, 3:4], d2, a1[:, 3:4] - a0[:, 3:4],
                         c_seg, oid,
                         np.zeros((n_clusters, 6, k), np.float32)], axis=1)
    return np.ascontiguousarray(tc.astype(np.float32))


class Clusters(NamedTuple):
    s0: torch.Tensor         # (S, 4) p0.xyz, r0 — cluster-ordered, padded
    s1: torch.Tensor         # (S, 4) p1.xyz, r1
    tc: torch.Tensor         # (C, 16, k) per-cluster kernel tiles
    cmin: torch.Tensor       # (C, 3) cluster AABB min
    cmax: torch.Tensor       # (C, 3)
    seg_index: torch.Tensor  # (S,) int32 original segment id, -1 = padding
    n_clusters: int
    cluster_size: int

    def to(self, device):
        return self._replace(**{k: getattr(self, k).to(device) for k in (
            "s0", "s1", "tc", "cmin", "cmax", "seg_index")})

    # the integrator's searches (``scene.accel``); intersect_kernel
    # imports this module, so they import it when called
    def nearest(self, o, d):
        from . import intersect_kernel as ik
        return ik.make_nearest_fn(self, device=o.device)(o, d)

    def occluded(self, o, d, limit):
        from . import intersect_kernel as ik
        return ik.make_occluded_fn(self, device=o.device)(o, d, limit)

    winners, sort_box = seg.Scan.winners, seg.Scan.sort_box


def build(p0, p1, r0, r1, cluster_size=CLUSTER_SIZE, device="cpu",
          use_native=True, method="median"):
    """Host-side build: the native C++ builder when it can be had
    (``accel/native.py``), else numpy (``accel/lbvh.py``).

    method: "median" (longest-axis median splits: about 2x tighter
    cluster boxes than Morton runs on dense hair) or "morton". The two
    routes may order a scene's segments differently (the native build
    reads float32 inputs); the kernels' (t, original id) tie-break makes
    the hits the same.
    """
    out = (native.build_clusters(p0, p1, r0, r1, cluster_size,
                                 method=method) if use_native else None)
    if out is not None:
        s0, s1 = out["s0"], out["s1"]
        cmin, cmax = out["cmin"], out["cmax"]
        seg_index, c = out["seg_index"], out["n_clusters"]
    else:
        host = lbvh.build(p0, p1, r0, r1, leaf_size=cluster_size,
                          method=method)
        c, seg_index = int(host.n_leaves), host.seg_index
        # the leaf boxes: heap level [n_leaves, 2 n_leaves); empty
        # (all-padding) clusters -> never-hit sentinel boxes
        cmin, cmax = host.node_min[c:], host.node_max[c:]
        bad = ~np.isfinite(cmin).all(1)
        cmin = np.where(bad[:, None], 4e30, cmin).astype(np.float32)
        cmax = np.where(bad[:, None], 4e30, cmax).astype(np.float32)
        s0 = np.concatenate([host.p0, host.r0[:, None]], 1).astype(
            np.float32)
        s1 = np.concatenate([host.p1, host.r1[:, None]], 1).astype(
            np.float32)
    tc = _tiles(s0, s1, seg_index, c, cluster_size)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return Clusters(s0=t(s0), s1=t(s1), tc=t(tc), cmin=t(cmin),
                    cmax=t(cmax), seg_index=t(seg_index), n_clusters=c,
                    cluster_size=cluster_size)
