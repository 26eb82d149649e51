"""triangle_search_ms.fwdbwd: device ms per 2^20 camera samples of the
kernels launched under geometry/triangles._search (scenes with
meshes)."""

from perfbench.lib.readers import ms_per_msample

SPANS = {"layer:triangle_search":
         "yhair_tpu_torch.geometry.triangles:_search"}


def read(run):
    if run.unit_name != "fwdbwd_step" or run.profile is None:
        return None
    return ms_per_msample(run, run.profile.device_us("layer:triangle_search"))
