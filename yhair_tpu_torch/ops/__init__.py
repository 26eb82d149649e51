"""Cluster acceleration structure and the CUDA kernels of the search.

``build_scene_clusters`` reorders a Scene's segments into clusters and
carries the structure in ``scene.accel``, which the integrator's
intersection and occlusion queries ask.
"""

from __future__ import annotations

from ..core.scene import Scene
from ..device import resolve_device
from ..geometry.segments import Segments
from . import clusters


def build_scene_clusters(scene: Scene, cluster_size=128, device=None,
                         use_native=True, method="median"):
    """-> (scene with cluster-ordered segments and accel, Clusters), both
    on ``device`` (the card unless ``device="cpu"``). use_native and
    method go to ``clusters.build``."""
    dev = resolve_device(device)
    cl = clusters.build(*(x.cpu().numpy() for x in scene.segments),
                        cluster_size=cluster_size, device=dev,
                        use_native=use_native, method=method)
    reordered = Segments(cl.s0[:, :3].contiguous(),
                         cl.s1[:, :3].contiguous(),
                         cl.s0[:, 3].contiguous(), cl.s1[:, 3].contiguous())
    return scene.with_accel(cl, reordered, cl.seg_index), cl
