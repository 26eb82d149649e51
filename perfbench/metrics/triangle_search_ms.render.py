"""triangle_search_ms.render: device ms per 2^20 camera samples of the
operations launched in the program's yhair.triangles spans (each
geometry/triangles._search call: the nearest and shadow searches over a
scene's triangles), in the host + device window (lib/program.py).
Scenes with meshes only."""

from perfbench.lib.program import ms, prepare  # noqa: F401


def read(run):
    return ms(run, "image", "triangles", "device_ns")
