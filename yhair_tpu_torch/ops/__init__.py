"""Cluster acceleration structure and the CUDA kernels of the search.

``build_scene_clusters`` reorders a Scene's segments into clusters and
carries the structure in ``scene.accel``, which the integrator's
intersection and occlusion queries read.
"""

from __future__ import annotations

import torch

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
    segs = scene.segments
    cl = clusters.build(*(x.cpu().numpy() for x in segs),
                        cluster_size=cluster_size, device=dev,
                        use_native=use_native, method=method)
    reordered = Segments(cl.s0[:, :3].contiguous(),
                         cl.s1[:, :3].contiguous(),
                         cl.s0[:, 3].contiguous(), cl.s1[:, 3].contiguous())
    sidx = cl.seg_index.long()
    smid = scene.seg_mat_id.to(dev)[torch.clamp(sidx, min=0)]
    smid = torch.where(sidx >= 0, smid, 0).to(torch.int32)
    scene2 = scene.to(dev)._replace(segments=reordered, accel=cl,
                                    seg_mat_id=smid)
    return scene2, cl
