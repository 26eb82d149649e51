"""Acceleration structures (``yhair_tpu/accel``).

``build_scene_bvh`` rewrites a Scene so its segment SoA is the BVH's
ordered, padded layout and carries the ``DeviceBVH`` in ``scene.accel``,
so the walk's hit indices line up with the shading's gathers. It mirrors
``ops.build_scene_clusters``.
"""

from __future__ import annotations

import torch

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
    sidx = bvh.seg_index.long()
    smid = scene.seg_mat_id.to(dev)[torch.clamp(sidx, min=0)]
    smid = torch.where(sidx >= 0, smid, 0).to(torch.int32)
    scene2 = scene.to(dev)._replace(segments=reordered, accel=bvh,
                                    seg_mat_id=smid)
    return scene2, bvh
