"""The readers of the program's own spans and counters
(perfbench/lib/program.py): self-intervals, device time by launch
time, idle overlap and the idle gaps by innermost span on a hand-built
trace, and ``prepare``'s window."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import ROOT, cells, run_tiny

from perfbench.lib import program, profiling

# host ranges (start, end, name), ns: one bounce holding a nearest
# search (with its list build) and the shading (with a shadow search)
SPANS = [(0, 100, "yhair.bounce"),
         (10, 30, "yhair.search"), (12, 20, "yhair.lists"),
         (40, 90, "yhair.shading"), (60, 70, "yhair.search"),
         (200, 300, "yhair.bounce"), (210, 220, "yhair.search"),
         (230, 280, "yhair.shading")]
# device operations (start, end, name) with their launch times; the
# last is a device mark of a range, no operation
DEVICE = [(14, 18, "slab", 13), (22, 26, "hit", 21), (45, 50, "bsdf", 41),
          (52, 56, "bsdf", 51), (63, 67, "any", 61), (95, 99, "mul", 85),
          (240, 250, "bsdf", 235), (41, 89, "yhair.shading", None)]


def test_union_and_subtract():
    u = program.union([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5)])
    assert u.tolist() == [[0, 4], [5, 7]]
    d = program.subtract(u, program.union([(1, 2), (3.5, 6)]))
    assert d.tolist() == [[0, 1], [2, 3.5], [6, 7]]
    assert program.overlap(u, program.union([(-1, 1), (3, 6)])) == 3.0


def test_self_intervals():
    assert program.self_intervals(SPANS, "yhair.shading").tolist() == [
        [40, 60], [70, 90], [230, 280]]
    assert program.self_intervals(SPANS, "yhair.search").tolist() == [
        [10, 12], [20, 30], [60, 70], [210, 220]]
    assert program.self_intervals(SPANS, "yhair.bounce").tolist() == [
        [0, 10], [30, 40], [90, 100], [200, 210], [220, 230], [280, 300]]


def _table():
    dev = [(a, b, n) for a, b, n, _ in DEVICE]
    launch = [np.nan if t is None else t for *_, t in DEVICE]
    dur = [b - a for a, b, _, _ in DEVICE]
    return program.span_table(SPANS, dev, launch, dur)


def test_device_time_by_launch_and_idle_overlap():
    table, after = _table()
    sh = table["yhair.shading"]
    # launched in shading's self time: the two bsdf ops and the mul of
    # bounce 1, the bsdf of bounce 2; the shadow search's "any" is the
    # search's
    assert sh["device_ns"] == 5 + 4 + 4 + 10
    assert sh["self_ns"] == 20 + 20 + 50
    # busy in [40, 60]: 45-50, 52-56; in [70, 90]: none; in [230, 280]:
    # 240-250; the range's own device mark (41-89) is left out
    assert sh["idle_ns"] == 90 - (5 + 4 + 10) == 71
    assert sh["count"] == 2
    assert table["yhair.search"]["device_ns"] == 4 + 4
    assert table["yhair.lists"]["device_ns"] == 4
    # the mul launched at 85 (shading) runs at 95-99, in the bounce's
    # self time: busy there, but not launched there
    assert table["yhair.bounce"]["device_ns"] == 0
    assert table["yhair.bounce"]["idle_ns"] == 70 - 4
    assert after == 1.0


class _Event:
    def __init__(self, a, b, name, corr, device):
        self._a, self._b, self._n, self._c, self._d = a, b, name, corr, device

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def name(self):
        return self._n

    def correlation_id(self):
        return self._c

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def is_user_annotation(self):
        return False


def _profile():
    """A profiling.Profile over the hand-built trace, as the profiler's
    raw events give it: each operation tied to its launch call by a
    correlation id."""
    events = [_Event(a, b, n, 0, False) for a, b, n in SPANS]
    for k, (a, b, n, t) in enumerate(DEVICE):
        corr = 0 if t is None else k + 1
        events.append(_Event(a, b, n, corr, True))
        if t is not None:
            events.append(_Event(t, t + 1, "cudaLaunchKernel", corr, False))
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return profiling.Profile(prof, 1.0, 1)


def test_idle_gaps_by_innermost_span():
    """Each idle gap of the device goes to the innermost yhair.* span
    open at its middle, else to the innermost host range, else to none:
    [0, 14] and [26, 41] and [89, 95] in the bounce, [18, 22] in the
    list build, [250, 300] in the shading, [99, 240] between units."""
    gaps = dict(_profile().idle_gaps())
    want = {"(between host operations)": 141, "yhair.shading": 50,
            "yhair.bounce": 14 + 15 + 6, "yhair.lists": 4}
    assert list(gaps) == list(want)
    for k, ns in want.items():
        assert gaps[k] == pytest.approx(ns / 1e9)


def test_readers_on_a_profile(capsys):
    import torch
    run = SimpleNamespace(
        cache={}, profile=_profile(), device=torch.device("cuda", 0),
        unit_name="image", samples_per_unit=1 << 20, rays_per_unit=3)
    run.cache[program.KEY] = {"counters": {
        "rays.bounce_lanes": 200, "rays.bounce_live": 150,
        "rays.shadow_lanes": 400, "rays.shadow_live": 210}}
    assert program.ms(run, "image", "shading",
                      "device_ns") == pytest.approx(23e-6)
    assert program.ms(run, "image", "shading",
                      "idle_ns") == pytest.approx(71e-6)
    assert program.ms(run, "fwdbwd_step", "shading", "device_ns") is None
    assert program.ms(run, "image", "backward", "idle_ns") is None
    assert program.live_share(run, "image") == 60.0
    assert "span yhair.shading x2" in capsys.readouterr().err
    run.device = torch.device("cpu")
    run.cache = {}
    assert program.layers(run) is None
    assert program.live_share(run, "image") is None


def test_prepare_traces_until_its_undo():
    from yhair_tpu_torch.utils import trace
    run = SimpleNamespace(cache={})
    trace.add("stale", 1)
    undo = program.prepare(run)
    assert trace.enabled() and trace.counters() == {}
    assert program.prepare(run) is None       # once a run
    trace.add("rays.bounce_lanes", 5)
    undo()
    assert not trace.enabled()
    assert run.cache[program.KEY]["counters"] == {"rays.bounce_lanes": 5}
    trace.reset()


def test_prepare_without_the_programs_tracing(monkeypatch):
    """A program that has no tracing module: no hooks, no error."""
    import yhair_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "yhair_tpu_torch.utils.trace", None)
    run = SimpleNamespace(cache={})
    assert program.prepare(run) is None
    assert program.live_share(SimpleNamespace(
        cache=run.cache, unit_name="image"), "image") is None


def live_share_cases(src=ROOT):
    """(cell, metric) of each cell that reports a search_live_share."""
    from perfbench.lib import harness
    layout = harness.Layout(src)
    return [(c, m["name"]) for c in cells(src)
            for m in layout.metrics_of(c)[1]
            if m["name"].startswith("search_live_share.")]


CASES = live_share_cases()


@pytest.mark.parametrize("cell", [c for c, _ in CASES])
def test_traced_tiny_run_counts_the_lanes(runmod, tiny_root, cell):
    """A traced CPU run: the live share from the counters; no span
    metric, whose device numbers only a card gives; tracing off after."""
    from perfbench.lib import harness
    from yhair_tpu_torch.utils import trace
    out = run_tiny(runmod, tiny_root, cell, trace=1)
    metric = dict(live_share_cases(tiny_root))[cell]
    share = out["metrics"][metric]["value"]
    assert 0 < share < 100
    spans = [m["name"] for m in harness.Layout(tiny_root).metrics_of(cell)[1]
             if m["source"] == "program_span"]
    assert spans and not set(spans) & set(out["metrics"])
    assert not trace.enabled()
