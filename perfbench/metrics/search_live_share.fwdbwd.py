"""search_live_share.fwdbwd: percent of the lanes of every nearest and
shadow search that carried a live path, from the program's counters
(rays.bounce_live + rays.shadow_live over rays.bounce_lanes +
rays.shadow_lanes) over the traced units (lib/program.py)."""

from perfbench.lib.program import live_share, prepare  # noqa: F401


def read(run):
    return live_share(run, "fwdbwd_step")
