"""backward_ms.fwdbwd: device ms per 2^20 camera samples of the
operations launched in the self time of the program's yhair.backward
spans (each strip's ``backward()``: the autograd engine's kernels), in
the host + device window (lib/program.py)."""

from perfbench.lib.program import ms, prepare  # noqa: F401


def read(run):
    return ms(run, "fwdbwd_step", "backward", "device_ns")
