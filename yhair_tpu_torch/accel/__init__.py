"""Acceleration structures (``yhair_tpu/accel``).

``build_scene_bvh`` rewrites a Scene so its segment SoA is the BVH's
ordered, padded layout and carries the ``DeviceBVH`` in ``scene.accel``,
so the walk's hit indices line up with the shading's gathers.

``scene.accel`` is the integrator's one seam to the segment search: the
cluster search (``ops.clusters.Clusters``), posed instances of it
(``instanced.InstancedClusters``) and the BVH (``traverse.DeviceBVH``)
each answer ``nearest``, ``occluded``, ``winners`` and ``sort_box``, as
the brute-force ``geometry.segments.Scan`` does for a scene without one.
"""

from __future__ import annotations

from ..core.scene import Scene
from ..device import resolve_device
from ..geometry.segments import Segments
from . import lbvh, traverse


def build_scene_bvh(scene: Scene, leaf_size=4, device=None):
    """-> (scene with the BVH's ordered segments and accel, DeviceBVH),
    both on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    host = lbvh.build(*(x.detach().cpu().numpy() for x in scene.segments),
                      leaf_size=leaf_size)
    bvh = traverse.DeviceBVH.from_host(host, device=dev)
    reordered = Segments(bvh.p0, bvh.p1, bvh.r0, bvh.r1)
    return scene.with_accel(bvh, reordered, bvh.seg_index), bvh
