"""cluster_lists_ms.fwdbwd: device ms per 2^20 camera samples of the
kernels launched under ops/intersect_kernel._block_cluster_lists."""

from perfbench.lib.readers import ms_per_msample

SPANS = {"layer:cluster_lists":
         "yhair_tpu_torch.ops.intersect_kernel:_block_cluster_lists"}


def read(run):
    if run.unit_name != "fwdbwd_step":
        return None
    return ms_per_msample(run, run.profile.device_us("layer:cluster_lists"))
