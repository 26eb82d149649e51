"""backward_ms.fwdbwd: device ms per 2^20 camera samples of the
kernels the autograd engine launched (every
"autograd::engine::evaluate_function:" range)."""

from perfbench.lib.readers import ms_per_msample


def read(run):
    if run.unit_name != "fwdbwd_step" or run.profile is None:
        return None
    return ms_per_msample(run, run.profile.autograd_device_us)
