"""device_idle_share.render: percent of the traced window in which no
device operation ran: 1 - the union of the device events' intervals
over the window's host-clock length, both from one window profiled
with the device's activity alone (the host runs near its untraced
speed there)."""

from perfbench.lib.readers import idle_share


def read(run):
    return idle_share(run, "image")
