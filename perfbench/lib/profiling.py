"""The traced run: two ``torch.profiler`` windows over whole units, and
what is read from them. The first records the device's activity alone
(``DeviceWindow``): with no host events to record, the host runs near
its untraced speed, so the device's busy share of that window is the
idle share of a run. The second records host and device (``Profile``):
host ranges (the program's ``yhair.*`` spans among them, read by
``lib/program.py``), device operations with the host time of their
launch, kernels by name, and what the host was doing while the device
idled; its host cost stretches its window. Kernels launched through
ctypes are found by their names in the device trace.
"""

from __future__ import annotations

import re
import time

import numpy as np

WINDOW = "perfbench:window"
# the program's own spans (yhair_tpu_torch/utils/trace.py)
PROGRAM = "yhair."


def _ns(e):
    start = e.start_ns()
    return start, start + e.duration_ns()


def _is_device(e):
    from torch.autograd import DeviceType
    return e.device_type() in (DeviceType.CUDA,
                               getattr(DeviceType, "PrivateUse1", None))


def _union(intervals):
    """Sorted, merged (start, end) pairs as two numpy arrays."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    arr = np.array(merged, dtype=np.float64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


class Profile:
    """What a profiled window holds, read from the profiler's raw events
    (building its per-event Python objects takes minutes for an image's
    worth of operations): device operations with the host time of their
    launch (by correlation id), host ranges, and the window."""

    def __init__(self, prof, window_s, units):
        self.window_s = window_s
        self.units = units
        launch_at = {}
        dev, host, win = [], [], None
        for e in prof.profiler.kineto_results.events():
            a, b = _ns(e)
            name = e.name()
            if _is_device(e):
                note = getattr(e, "is_user_annotation", None)
                if name == WINDOW or (note is not None and note()):
                    continue
                dev.append((a, b, name, e.correlation_id()))
            else:
                host.append((a, b, name))
                # the runtime's launch calls carry the kernels' ids
                if e.correlation_id() and name.startswith("cu"):
                    launch_at[e.correlation_id()] = a
                if name == WINDOW:
                    win = (a, b)
        if win is None:
            win = (min([h[0] for h in host] or [0]),
                   max([h[1] for h in host] or [0]))
        self.win = win
        dev.sort()
        host.sort()
        self.host = host
        self.device_events = [(a, b, n) for a, b, n, _ in dev]
        self._launch = np.array([launch_at.get(c, np.nan) for *_, c in dev],
                                dtype=np.float64)
        self._dur = np.array([b - a for a, b, _, _ in dev], dtype=np.float64)

    def kernels(self, pattern):
        """Device events whose name matches, in order, each (start ns,
        end ns)."""
        rx = re.compile(pattern)
        return [(a, b) for a, b, n in self.device_events if rx.search(n)]

    def busy_intervals(self):
        """The union of device-event intervals inside the window."""
        lo, hi = self.win
        merged = []
        for a, b, _ in self.device_events:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def idle_gaps(self, top=10):
        """[[name, seconds]]: the device's idle time in the window, summed
        by what the host was doing at the middle of each gap: the
        innermost of the program's ``yhair.*`` spans open there, else the
        innermost host range open there (the latest-starting one that has
        not ended); largest first."""
        lo, hi = self.win
        busy = self.busy_intervals()
        edges = np.array([lo] + [x for ab in busy for x in ab] + [hi])
        a, b = edges[0::2], edges[1::2]
        keep = b > a
        a, b = a[keep], b[keep]
        if not len(a):
            return []
        mid = 0.5 * (a + b)
        host = [h for h in self.host if h[2] != WINDOW]
        spans = [h for h in host if h[2].startswith(PROGRAM)]
        names = []
        for i, j in zip(_innermost(spans, mid), _innermost(host, mid)):
            names.append(spans[i][2] if i >= 0 else host[j][2] if j >= 0
                         else "(between host operations)")
        totals = {}
        for name, dt in zip(names, (b - a) / 1e9):
            totals[name] = totals.get(name, 0.0) + float(dt)
        items = sorted(totals.items(), key=lambda kv: -kv[1])
        return [[k[:120], v] for k, v in items[:top]]


def _innermost(ranges, times):
    """ranges: [(start, end, name)] sorted by start; times: ascending. ->
    for each time the index of the latest-starting range open at it (start
    <= t <= end), or -1. One sweep: a range is pushed when the sweep
    passes its start, and popped from the top once it has ended, since no
    later time finds it open."""
    out = np.full(len(times), -1)
    stack, j = [], 0
    for q, t in enumerate(times):
        while j < len(ranges) and ranges[j][0] <= t:
            stack.append(j)
            j += 1
        while stack and ranges[stack[-1]][1] < t:
            stack.pop()
        if stack:
            out[q] = stack[-1]
    return out


class DeviceWindow:
    """Whole units under a profiler that records the device's activity
    only: the device's busy seconds (the union of its operations'
    intervals), the window's length on the host clock, and the
    operations that took most time."""

    def __init__(self, prof, window_s):
        self.window_s = window_s
        by_name, spans = {}, []
        for e in prof.profiler.kineto_results.events():
            if _is_device(e):
                a, b = _ns(e)
                spans.append((a, b))
                by_name[e.name()] = by_name.get(e.name(), 0) + (b - a)
        lo, hi = _union(spans)
        self.busy_s = float((hi - lo).sum()) / 1e9
        self.by_name = by_name

    def device_ops(self, top=10):
        """[[kernel name, seconds]] of the device operations that took
        most time."""
        items = sorted(self.by_name.items(), key=lambda kv: -kv[1])
        return [[k[:120], v / 1e9] for k, v in items[:top]]


def _profiled(unit, first, n_units, device, host):
    """Units first .. first + n_units - 1 under the profiler, the window
    closed by a device sync. -> (profiler, window seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for k in range(first, first + n_units):
                unit(k)
            if cuda:
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    return prof, window_s


def device_window(unit, first, n_units, device):
    """Run the units with the device's activity recorded. ->
    DeviceWindow."""
    prof, window_s = _profiled(unit, first, n_units, device, host=False)
    return DeviceWindow(prof, window_s)


def profile_units(unit, first, n_units, device):
    """Run the units with host and device activity recorded. ->
    Profile."""
    prof, window_s = _profiled(unit, first, n_units, device, host=True)
    return Profile(prof, window_s, n_units)
