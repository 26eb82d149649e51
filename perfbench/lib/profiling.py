"""The traced run: two ``torch.profiler`` windows over whole units, and
what is read from them. The first records the device's activity alone
(``DeviceWindow``): with no host events to record, the host runs near
its untraced speed, so the device's busy share of that window is the
idle share of a run. The second records host and device (``Profile``):
labelled ranges around program functions, the device time launched
under each, kernels by name, and the host ranges open while the device
idled; its host cost stretches its window.

Ranges are the benchmark's own: a metric file names program functions
(``"package.module:function"``) and the harness replaces each module
attribute by a wrapper that opens a ``record_function`` range, for the
traced window only. The program's callers look the attribute up when
they call it, so they enter the range. Kernels launched through ctypes
are not tied to a range; they are found by their names in the device
trace.
"""

from __future__ import annotations

import importlib
import re
import time
from contextlib import contextmanager

import numpy as np

WINDOW = "perfbench:window"
AUTOGRAD = "autograd::engine::evaluate_function:"


@contextmanager
def spans(labels):
    """labels: {label: "module:function"}; wraps each for the block."""
    from torch.profiler import record_function

    patched = []

    def labelled(label, fn):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run
    try:
        for label, where in labels.items():
            mod_name, attr = where.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            setattr(mod, attr, labelled(label, orig))
            patched.append((mod, attr, orig))
        yield
    finally:
        for mod, attr, orig in reversed(patched):
            setattr(mod, attr, orig)


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


def _inside(times, intervals):
    """Boolean mask: which times fall inside the union of intervals."""
    lo, hi = _union(intervals)
    if not len(lo):
        return np.zeros(len(times), dtype=bool)
    k = np.searchsorted(lo, times, side="right") - 1
    return (k >= 0) & (times <= hi[np.maximum(k, 0)])


class Profile:
    """What a profiled window holds, read from the profiler's raw events
    (building its per-event Python objects takes minutes for an image's
    worth of operations): device operations with the host time of their
    launch (by correlation id), host ranges, and the window."""

    def __init__(self, prof, window_s, units, labels=()):
        self.window_s = window_s
        self.units = units
        # the ranges' own marks on the device timeline are no operations
        skip = set(labels) | {WINDOW}
        launch_at = {}
        dev, host, win = [], [], None
        for e in prof.profiler.kineto_results.events():
            a, b = _ns(e)
            name = e.name()
            if _is_device(e):
                note = getattr(e, "is_user_annotation", None)
                if name in skip or (note is not None and note()):
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
        self._ranges = {}
        for a, b, n in host:
            if n in skip or n.startswith(AUTOGRAD):
                self._ranges.setdefault(
                    AUTOGRAD if n.startswith(AUTOGRAD) else n, []).append(
                        (a, b))

    def _device_ns_under(self, key):
        spans = self._ranges.get(key, [])
        if not spans or not len(self._dur):
            return 0.0
        return float(self._dur[_inside(self._launch, spans)].sum())

    @property
    def autograd_device_us(self):
        """Device microseconds of the operations the autograd engine
        launched."""
        return self._device_ns_under(AUTOGRAD) / 1e3

    def device_us(self, label):
        """Device microseconds of the operations launched under a range."""
        return self._device_ns_under(label) / 1e3

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

    def idle_gaps(self, top=10, walk=64):
        """[[host range, seconds]]: the device's idle time in the window,
        summed by the innermost host range open at the middle of each
        gap (the latest-starting one that has not ended), largest
        first."""
        lo, hi = self.win
        busy = self.busy_intervals()
        edges = np.array([lo] + [x for ab in busy for x in ab] + [hi])
        a, b = edges[0::2], edges[1::2]
        keep = b > a
        a, b = a[keep], b[keep]
        host = [h for h in self.host if h[2] != WINDOW]
        if not len(a):
            return []
        starts = np.array([h[0] for h in host] or [np.inf])
        ends = np.array([h[1] for h in host] or [-np.inf])
        names = [h[2] for h in host] or ["(between host operations)"]
        mid = 0.5 * (a + b)
        idx = np.searchsorted(starts, mid, side="right") - 1
        found = np.full(mid.shape, -1)
        open_ = idx >= 0
        for _ in range(walk):
            ok = open_ & (found < 0) & (ends[np.maximum(idx, 0)] >= mid)
            found[ok] = idx[ok]
            idx = np.where(open_ & (found < 0), idx - 1, idx)
            open_ = open_ & (idx >= 0)
            if not (open_ & (found < 0)).any():
                break
        totals = {}
        for f, dt in zip(found, (b - a) / 1e9):
            name = names[f] if f >= 0 else "(between host operations)"
            totals[name] = totals.get(name, 0.0) + float(dt)
        items = sorted(totals.items(), key=lambda kv: -kv[1])
        return [[k[:120], v] for k, v in items[:top]]


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


def profile_units(unit, first, n_units, device, labels=()):
    """Run the units with host and device activity recorded. ->
    Profile."""
    prof, window_s = _profiled(unit, first, n_units, device, host=True)
    return Profile(prof, window_s, n_units, labels)
