"""What the metric files that read the program's own spans and counters
share (``yhair_tpu_torch/utils/trace.py``).

With its tracing on, the program opens ``yhair.<layer>`` ranges
(``record_function``), which the profiler records on the clock of the
device's events, and sums lane counters on the device. ``prepare``
turns tracing on for the host + device window alone: ``run.py`` calls
it after the device-only window, so ``device_idle_share`` and the
device ops still see the untraced program. Its undo stores the
counters in ``run.cache`` and turns tracing off.

``layers(run)`` reads the window's ``yhair.*`` ranges from
``run.profile.host``. For each name: its self-intervals (its intervals
minus those of the ``yhair.*`` spans nested in them), the device time
launched in them (each operation by the host time of its launch, as
``Profile`` records it), and the device's idle time in them
(their length minus their exact overlap with the union of the device's
operations). Device marks of the ranges themselves (device events named
``yhair.*``) are no operations and are left out. Against a program
without these spans or counters every reader returns None.
"""

from __future__ import annotations

import sys

import numpy as np

PREFIX = "yhair."
KEY = "program"


def prepare(run):
    """Reset and turn on the program's tracing, once a run. -> the undo
    (store the counters in ``run.cache``, turn tracing off), or None
    where another metric file prepared it already or the program has
    no tracing."""
    if KEY in run.cache:
        return None
    run.cache[KEY] = {}
    try:
        from yhair_tpu_torch.utils import trace
    except ImportError:
        return None
    trace.reset()
    trace.enable()

    def undo():
        try:
            run.cache[KEY]["counters"] = trace.counters()
        finally:
            trace.disable()
    return undo


def union(intervals):
    """(k, 2) float64 array of the sorted, merged (start, end) pairs."""
    arr = np.asarray(intervals, dtype=np.float64).reshape(-1, 2)
    if not len(arr):
        return arr
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    # a new piece starts where an interval begins after every earlier end
    ends = np.maximum.accumulate(arr[:, 1])
    new = np.ones(len(arr), dtype=bool)
    new[1:] = arr[1:, 0] > ends[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:], len(arr)) - 1
    return np.stack([arr[first, 0], ends[last]], 1)


def _below(merged, t):
    """Length of the merged intervals that lies below each time t."""
    t = np.asarray(t, dtype=np.float64)
    if not len(merged):
        return np.zeros_like(t)
    lo, hi = merged[:, 0], merged[:, 1]
    cum = np.concatenate([[0.0], np.cumsum(hi - lo)])
    k = np.searchsorted(lo, t, side="right")
    j = np.maximum(k - 1, 0)
    part = np.clip(t - lo[j], 0.0, hi[j] - lo[j])
    return np.where(k > 0, cum[j] + part, 0.0)


def overlap(a, b):
    """Length of the intersection of two merged interval arrays."""
    if not len(a) or not len(b):
        return 0.0
    return float((_below(b, a[:, 1]) - _below(b, a[:, 0])).sum())


def subtract(a, b):
    """The merged intervals a minus the merged intervals b."""
    out = []
    for s, e in a:
        k = np.searchsorted(b[:, 1], s, side="right") if len(b) else 0
        while s < e and k < len(b) and b[k, 0] < e:
            if b[k, 0] > s:
                out.append((s, b[k, 0]))
            s = max(s, b[k, 1])
            k += 1
        if s < e:
            out.append((s, e))
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def contained(intervals, merged):
    """Mask: which (start, end) pairs lie inside one merged interval."""
    iv = np.asarray(intervals, dtype=np.float64).reshape(-1, 2)
    if not len(iv) or not len(merged):
        return np.zeros(len(iv), dtype=bool)
    k = np.searchsorted(merged[:, 0], iv[:, 0], side="right") - 1
    j = np.maximum(k, 0)
    return (k >= 0) & (iv[:, 1] <= merged[j, 1])


def inside(times, merged):
    """Mask: which times fall inside the merged intervals (NaN: none)."""
    times = np.asarray(times, dtype=np.float64)
    if not len(merged):
        return np.zeros(len(times), dtype=bool)
    k = np.searchsorted(merged[:, 0], times, side="right") - 1
    return (k >= 0) & (times <= merged[np.maximum(k, 0), 1])


def self_intervals(spans, name):
    """spans: [(start, end, name)] of the ``yhair.*`` ranges. -> the
    merged intervals of ``name`` minus those of the other spans nested
    in them."""
    own = union([(a, b) for a, b, n in spans if n == name])
    other = [(a, b) for a, b, n in spans if n != name]
    nested = [iv for iv, ok in zip(other, contained(other, own)) if ok]
    return subtract(own, union(nested))


def span_table(spans, device_events, launch, dur):
    """-> ({name: {"self_ns", "device_ns", "idle_ns", "count"}} of every
    ``yhair.*`` name, the share of the operations launched inside a span
    whose device start comes no earlier than the self-interval their
    launch fell in, or None where none was).

    spans: [(start, end, name)] host ranges; device_events: [(start,
    end, name)]; launch, dur: each device event's launch time (NaN if
    unknown) and duration, aligned with device_events."""
    keep = np.array([not n.startswith(PREFIX) for _, _, n in device_events],
                    dtype=bool)
    ev = np.asarray([(a, b) for a, b, _ in device_events],
                    dtype=np.float64).reshape(-1, 2)[keep]
    launch = np.asarray(launch, dtype=np.float64).reshape(-1)[keep]
    dur = np.asarray(dur, dtype=np.float64).reshape(-1)[keep]
    busy = union(ev)
    table, pieces = {}, []
    for name in sorted({n for _, _, n in spans}):
        own = self_intervals(spans, name)
        length = float((own[:, 1] - own[:, 0]).sum()) if len(own) else 0.0
        table[name] = {
            "self_ns": length,
            "device_ns": float(dur[inside(launch, own)].sum()),
            "idle_ns": length - overlap(own, busy),
            "count": sum(1 for _, _, n in spans if n == name)}
        pieces.append(own)
    pieces = union(np.concatenate(pieces) if pieces else [])
    hit = inside(launch, pieces)
    if not hit.any():
        return table, None
    k = np.searchsorted(pieces[:, 0], launch[hit], side="right") - 1
    return table, float((ev[hit, 0] >= pieces[k, 0]).mean())


def layers(run):
    """The span table of the run's host + device window, computed once
    and printed on standard error with the clock and lane checks; None
    without a card or without the program's spans."""
    cache = run.cache.setdefault(KEY, {})
    if "table" in cache:
        return cache["table"]
    cache["table"] = None
    prof = run.profile
    if prof is None or run.device.type != "cuda" or not prof.device_events:
        return None
    spans = [(a, b, n) for a, b, n in prof.host if n.startswith(PREFIX)]
    if not spans:
        return None
    table, after_open = span_table(spans, prof.device_events, prof._launch,
                                   prof._dur)
    cache["table"] = table
    report(run, table, after_open)
    return table


def report(run, table, after_open):
    """One line a span on standard error, in ms per 2^20 samples: self
    time, device time launched in it, device idle in it; then the clock
    check and the lanes against the counted rays."""
    per = run.samples_per_unit * run.profile.units / (1 << 20)
    for name, t in table.items():
        print(f"perfbench: span {name} x{t['count']}: self "
              f"{t['self_ns'] / 1e6 / per!r}, device "
              f"{t['device_ns'] / 1e6 / per!r}, idle "
              f"{t['idle_ns'] / 1e6 / per!r} ms/Msample", file=sys.stderr)
    print(f"perfbench: operations launched in a span that start after it "
          f"opens: {after_open!r}", file=sys.stderr)
    counts = run.cache.get(KEY, {}).get("counters") or {}
    lanes = (counts.get("rays.bounce_lanes", 0)
             + counts.get("rays.shadow_lanes", 0))
    print(f"perfbench: lanes {lanes} over {run.profile.units} units, "
          f"counted rays {run.profile.units * run.rays_per_unit}; "
          f"counters {counts}", file=sys.stderr)


def ms(run, unit_name, name, field):
    """A span's field (``device_ns`` or ``idle_ns``) in device ms per
    2^20 camera samples; None where the run has no such span."""
    from perfbench.lib.readers import ms_per_msample

    if run.unit_name != unit_name:
        return None
    table = layers(run)
    if not table or PREFIX + name not in table:
        return None
    return ms_per_msample(run, table[PREFIX + name][field] / 1e3)


def live_share(run, unit_name):
    """Percent of the searched lanes (nearest and shadow) that were
    live; None without the program's counters."""
    if run.unit_name != unit_name:
        return None
    c = run.cache.get(KEY, {}).get("counters") or {}
    lanes = c.get("rays.bounce_lanes", 0) + c.get("rays.shadow_lanes", 0)
    if lanes <= 0:
        return None
    live = c.get("rays.bounce_live", 0) + c.get("rays.shadow_live", 0)
    return 100.0 * live / lanes
