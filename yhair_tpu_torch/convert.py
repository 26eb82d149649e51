"""Hand the reference's scene state to the port.

The tests turn a ``yhair_tpu`` Scene, Clusters, InstancedClusters,
DeviceBVH or parameter dict into numpy arrays
(``{name: np.asarray(leaf)}``, see ``flat_fields``) and build the port's
counterpart from them here, so both packages compute on the same arrays.
Names are the reference's field paths joined with dots ("segments.p0",
"hair.beta_m", "accel.tc", ...); static ints ("accel.n_clusters") stay
ints. This module imports no JAX: ``np.asarray`` reads any array.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .accel.instanced import InstancedClusters
from .accel.traverse import DeviceBVH
from .bsdf.hair import HairMaterial
from .bsdf.surface import SurfaceMaterial
from .core.scene import Scene
from .device import resolve_device
from .geometry.segments import Segments
from .geometry.triangles import Triangles
from .ops.clusters import Clusters

# {field: feature} of the reference's features the port does not render
# (refused when the field's leading dimension is non-zero): none left
_UNSUPPORTED: dict = {}


def flat_fields(tree, prefix="") -> dict:
    """{dotted name: np.ndarray or int} of a NamedTuple tree (None leaves
    are left out)."""
    out = {}
    for name, v in tree._asdict().items():
        if v is None:
            continue
        if hasattr(v, "_asdict"):
            out.update(flat_fields(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = v if isinstance(v, int) else np.array(v)
    return out


def clusters_from_numpy(fields: dict, device=None) -> Clusters:
    """Clusters from {s0, s1, tc, cmin, cmax, seg_index, n_clusters,
    cluster_size}."""
    dev = resolve_device(device)

    def t(k):
        return torch.as_tensor(np.ascontiguousarray(fields[k]), device=dev)
    return Clusters(s0=t("s0"), s1=t("s1"), tc=t("tc"), cmin=t("cmin"),
                    cmax=t("cmax"), seg_index=t("seg_index"),
                    n_clusters=int(fields["n_clusters"]),
                    cluster_size=int(fields["cluster_size"]))


def instanced_from_numpy(fields: dict, device=None) -> InstancedClusters:
    """InstancedClusters from {cl.s0, ..., cl.cluster_size, R, t, R_inv,
    scale, inst_mat, bmin, bmax}."""
    dev = resolve_device(device)
    cl = clusters_from_numpy({k[len("cl."):]: v for k, v in fields.items()
                              if k.startswith("cl.")}, dev)
    return InstancedClusters(cl, *(
        torch.as_tensor(np.ascontiguousarray(fields[k]), device=dev)
        for k in InstancedClusters._fields[1:]))


def bvh_from_numpy(fields: dict, device=None) -> DeviceBVH:
    """DeviceBVH from {node_min, node_max, skip, p0, p1, r0, r1,
    seg_index, n_leaves, leaf_size}."""
    return DeviceBVH.from_host(SimpleNamespace(**fields),
                               device=resolve_device(device))


def scene_from_numpy(fields: dict, device=None) -> Scene:
    """Scene from the reference's flattened fields (hair leaves scalar or
    table-shaped, curves, a Clusters, InstancedClusters or DeviceBVH
    accel); raises NotImplementedError for a feature in
    ``_UNSUPPORTED``."""
    dev = resolve_device(device)
    found = [what for k, what in _UNSUPPORTED.items()
             if k in fields and np.shape(fields[k])[0]]
    if found:
        raise NotImplementedError(
            "yhair_tpu_torch does not render these scene features yet: "
            + ", ".join(found))

    def t(k):
        return torch.as_tensor(np.ascontiguousarray(fields[k]), device=dev)

    accel = None
    sub = {k[len("accel."):]: v for k, v in fields.items()
           if k.startswith("accel.")}
    if "cl.tc" in sub:
        accel = instanced_from_numpy(sub, dev)
    elif "tc" in sub:
        accel = clusters_from_numpy(sub, dev)
    elif "node_min" in sub:
        accel = bvh_from_numpy(sub, dev)
    nested = {"segments": Segments, "hair": HairMaterial,
              "surf_mat": SurfaceMaterial, "tris": Triangles}

    def field(name):
        if name not in nested:
            return t(name)
        return nested[name](*(t(f"{name}.{k}") for k in nested[name]._fields))
    return Scene(accel=accel, **{name: field(name) for name in Scene._fields
                                 if name != "accel"})


def params_from_numpy(arrays: dict, device=None) -> dict:
    """{name: float32 leaf tensor with requires_grad} from {name: array},
    e.g. the reference's hair parameters (``{"beta_m": ..., ...}``)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev,
                            requires_grad=True)
            for k, v in arrays.items()}
