"""Two-level acceleration: posed instances of one cluster build
(``yhair_tpu/accel/instanced.py``).

The canonical shape is clustered once; a query maps each ray into every
instance's frame and runs the same two CUDA kernels there. Frames are
rigid with one uniform scale. Local directions are kept unit length (the
kernels' closest-approach algebra assumes it), and a local distance is
turned back into the world's by the direction's length.

A hit's index lives in a virtual space, ``instance * S + segment`` over
the S canonical cluster-ordered segments; ``gather_world_segments``
poses the winner in world space for the integrator's recompute and
shading.

The top-level cull: a ray that misses an instance's posed box is sent
to the kernels with its origin at 1e8 (nearest) or t_max = 0
(occlusion), which empties its block lists. An instance that no ray of
the query touches is skipped; deciding that is one host sync per
instance and query (the reference's ``lax.cond``). Like the reference,
the nearest search does not mask a culled ray's result with its box
test.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.safemath import sqrt_rn
from ..device import resolve_device
from ..geometry.segments import Segments
from ..io.scene_json import frame_matrix
from ..ops import intersect_kernel as ik
from ..ops.clusters import Clusters

INF = ik.INF
T_MIN = ik.T_MIN


class InstancedClusters(NamedTuple):
    cl: Clusters             # the canonical shape's clusters, held once
    R: torch.Tensor          # (I, 3, 3) instance axes (with scale) as columns
    t: torch.Tensor          # (I, 3) instance origins
    R_inv: torch.Tensor      # (I, 3, 3)
    scale: torch.Tensor      # (I,) uniform scale
    inst_mat: torch.Tensor   # (I,) int32 hair-material table id
    bmin: torch.Tensor       # (I, 3) posed world box (top-level cull)
    bmax: torch.Tensor       # (I, 3)

    @property
    def n_instances(self):
        return self.R.shape[0]

    def to(self, device):
        return InstancedClusters(self.cl.to(device),
                                 *(a.to(device) for a in self[1:]))

    # the integrator's searches (``scene.accel``)
    def nearest(self, o, d):
        return make_nearest_fn(self, device=o.device)(o, d)

    def occluded(self, o, d, limit):
        return make_occluded_fn(self, device=o.device)(o, d, limit)

    def winners(self, segments, seg_mat_id, idx):
        """The winners posed in world space, arange(N), hair_mid."""
        *posed, hair_mid = gather_world_segments(self, segments, idx)
        return (Segments(*posed), torch.arange(idx.shape[0],
                                               device=idx.device), hair_mid)

    def sort_box(self, segments):
        """The canonical box's bounding sphere posed by every frame, as
        the reference does (only the sort's scale, never a result)."""
        lo, hi = self.cl.sort_box(segments)
        r = 0.87 * torch.linalg.norm(hi - lo)
        ctr = _apply(self.R, 0.5 * (lo + hi)) + self.t
        rad = (r * self.scale)[:, None]
        return (ctr - rad).amin(0), (ctr + rad).amax(0)


def build_instanced(cl: Clusters, frames, inst_mat=None,
                    device=None) -> InstancedClusters:
    """frames: 4x3 [x, y, z, origin] rows, one per instance; inst_mat:
    their hair-material table ids (default 0). On ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    Ms, ts, ss = zip(*(frame_matrix(fr) for fr in frames))
    R = np.stack(Ms)
    mats = (np.zeros(len(frames), np.int32) if inst_mat is None
            else np.asarray(inst_mat, np.int32))
    # the canonical root box is the union of the cluster boxes (all-padding
    # clusters carry 4e30 sentinels); its 8 corners posed by each frame
    # bound the instance in world space
    cmin, cmax = cl.cmin.cpu().numpy(), cl.cmax.cpu().numpy()
    fin = cmin[:, 0] < 1e30
    if not fin.any():
        raise ValueError("the clusters hold no segment to instance")
    corners = np.stack(np.meshgrid(*zip(cmin[fin].min(0), cmax[fin].max(0)),
                                   indexing="ij"), -1).reshape(8, 3)
    posed = np.einsum("iab,cb->ica", R, corners) + np.stack(ts)[:, None]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return InstancedClusters(
        cl=cl.to(dev), R=f32(R), t=f32(np.stack(ts)),
        R_inv=f32(np.stack([np.linalg.inv(M) for M in Ms])), scale=f32(ss),
        inst_mat=torch.as_tensor(mats, device=dev),
        bmin=f32(posed.min(1)), bmax=f32(posed.max(1)))


def _apply(M, v):
    """M @ v over the last axes: M (..., 3, 3), v (..., 3) -> (..., 3),
    summed in a fixed order so the card and the CPU agree."""
    return (M[..., :, 0] * v[..., 0:1] + M[..., :, 1] * v[..., 1:2]
            + M[..., :, 2] * v[..., 2:3])


def _box_interval(o, d, bmin, bmax):
    """Slab interval (tn, tf) of rays against one box; tn >= T_MIN."""
    small = torch.where(d < 0, -1e-12, 1e-12).to(d.dtype)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, small, d)
    t0 = (bmin[None] - o) * inv
    t1 = (bmax[None] - o) * inv
    tn = torch.clamp(torch.minimum(t0, t1).amax(-1), min=T_MIN)
    return tn, torch.maximum(t0, t1).amin(-1)


def _local_ray(ic: InstancedClusters, i, o, d):
    """World rays -> instance i's frame: (o_l, d_l unit, norm, delta).

    A world point at distance t lies at local distance t * norm, norm =
    |R^-1 d|. The kernels clip at T_MIN in local units, so the local
    origin is moved back by delta = T_MIN (1 - norm): the clip then acts
    at world distance T_MIN for every scale."""
    o_l = _apply(ic.R_inv[i], o - ic.t[i])
    d_l = _apply(ic.R_inv[i], d)
    norm = torch.clamp(sqrt_rn((d_l * d_l).sum(-1, keepdim=True)), min=1e-20)
    d_l = d_l / norm
    delta = T_MIN * (1.0 - norm[:, 0])
    return o_l - delta[:, None] * d_l, d_l, norm[:, 0], delta


def make_nearest_fn(ic: InstancedClusters, device=None):
    """fn(o, d) -> (t, virtual idx, hit): the nearest hit over every
    instance, on ``device``."""
    dev = resolve_device(device)
    ic = ic.to(dev)
    nearest = ik.make_nearest_fn(ic.cl, device=dev)
    n_seg = ic.cl.s0.shape[0]

    def fn(o, d):
        o, d = o.to(dev), d.to(dev)
        n = o.shape[0]
        t_best = torch.full((n,), INF, dtype=o.dtype, device=dev)
        idx_best = torch.zeros((n,), dtype=torch.int32, device=dev)
        hit_any = torch.zeros((n,), dtype=torch.bool, device=dev)
        for i in range(ic.n_instances):
            tn, tf = _box_interval(o, d, ic.bmin[i], ic.bmax[i])
            touch = tn <= tf
            if not bool(touch.any()):
                continue
            o_l, d_l, norm, delta = _local_ray(
                ic, i, torch.where(touch[:, None], o, 1e8), d)
            t_l, idx_i, hit_i = nearest(o_l, d_l)
            t_i = torch.where(hit_i, (t_l - delta) / norm, INF)
            better = t_i < t_best
            t_best = torch.where(better, t_i, t_best)
            idx_best = torch.where(better, i * n_seg + idx_i, idx_best)
            hit_any = hit_any | hit_i
        return t_best, idx_best, hit_any
    return fn


def make_occluded_fn(ic: InstancedClusters, device=None):
    """fn(o, d, t_max) -> (N,) bool: something lies in (T_MIN, t_max] in
    some instance."""
    dev = resolve_device(device)
    ic = ic.to(dev)
    occluded = ik.make_occluded_fn(ic.cl, device=dev)

    def fn(o, d, t_max):
        o, d, t_max = o.to(dev), d.to(dev), t_max.to(dev)
        occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=dev)
        for i in range(ic.n_instances):
            tn, tf = _box_interval(o, d, ic.bmin[i], ic.bmax[i])
            # only rays whose box interval starts before t_max can be
            # occluded here; the others get t_max 0 (below T_MIN)
            touch = (tn <= tf) & (tn <= t_max) & ~occ
            if not bool(touch.any()):
                continue
            o_l, d_l, norm, delta = _local_ray(ic, i, o, d)
            occ = occ | occluded(o_l, d_l,
                                 torch.where(touch, t_max * norm + delta, 0.0))
        return occ
    return fn


def gather_world_segments(ic: InstancedClusters, segments, idx):
    """Virtual idx -> the winners posed in world space: (p0, p1, r0, r1,
    the instance's hair-material id), differentiable in ``segments``."""
    n_seg = segments.p0.shape[0]
    idx = idx.long()
    inst = torch.div(idx, n_seg, rounding_mode="floor")
    sidx = idx % n_seg
    Rm, tv, s = ic.R[inst], ic.t[inst], ic.scale[inst]
    return (_apply(Rm, segments.p0[sidx]) + tv,
            _apply(Rm, segments.p1[sidx]) + tv,
            segments.r0[sidx] * s, segments.r1[sidx] * s, ic.inst_mat[inst])
