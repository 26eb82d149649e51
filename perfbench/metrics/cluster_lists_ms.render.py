"""cluster_lists_ms.render: device ms per 2^20 camera samples of the
operations launched in the program's yhair.lists spans (each
ops/intersect_kernel._block_cluster_lists call: one lists_kernel launch
on the card), in the host + device window (lib/program.py)."""

from perfbench.lib.program import ms, prepare  # noqa: F401


def read(run):
    return ms(run, "image", "lists", "device_ns")
