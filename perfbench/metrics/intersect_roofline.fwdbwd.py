"""intersect_roofline.fwdbwd: percent of the least time the card could
take for the hit and any kernels' work (perfbench/counts/work.py) over
the device time of their launches, over the searches of the first
traced strip."""

from perfbench.lib.readers import capture_searches, roofline


def prepare(run):
    return capture_searches(run)


def read(run):
    return roofline(run, "fwdbwd_step")
