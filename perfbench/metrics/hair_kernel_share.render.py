"""hair_kernel_share.render: percent of the hair lanes shaded (live after
the hit test, on hair) whose BSDF work ran in the program's hair kernel,
from its counters (shade.hair_kernel over shade.hair) over the traced
render units (lib/program.py); None where the program has no such
counters."""

from perfbench.lib.program import KEY, prepare  # noqa: F401


def read(run):
    if run.unit_name != "image":
        return None
    c = run.cache.get(KEY, {}).get("counters") or {}
    hair = c.get("shade.hair", 0)
    if hair <= 0 or "shade.hair_kernel" not in c:
        return None
    return 100.0 * c["shade.hair_kernel"] / hair
