"""hair_shade_share.fwdbwd: percent of the lanes shaded (live after the
hit test) that lie on hair, whose BSDF reads the hair material the
inverse's leaves drive, from the program's counters (shade.hair over
shade.live) over the traced units (lib/program.py); None where the
program has no such counters."""

from perfbench.lib.program import KEY, prepare  # noqa: F401


def read(run):
    if run.unit_name != "fwdbwd_step":
        return None
    c = run.cache.get(KEY, {}).get("counters") or {}
    live = c.get("shade.live", 0)
    if live <= 0:
        return None
    return 100.0 * c.get("shade.hair", 0) / live
