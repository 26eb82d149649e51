"""shading_ms.render: device ms per 2^20 camera samples of the operations
launched in the self time of the program's yhair.shading spans (the
bounce's work after its nearest search, without the shadow searches
nested in it; lib/program.py)."""

from perfbench.lib.program import ms, prepare  # noqa: F401


def read(run):
    return ms(run, "image", "shading", "device_ns")
