"""shading_idle_ms.render: ms per 2^20 camera samples in which the device
ran nothing during the self time of the program's yhair.shading spans,
in the host + device window (lib/program.py)."""

from perfbench.lib.program import ms, prepare  # noqa: F401


def read(run):
    return ms(run, "image", "shading", "idle_ns")
