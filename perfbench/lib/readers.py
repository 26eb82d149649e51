"""What the metric files share: device time per 2^20 camera samples,
the idle share of the device-only traced window, and the kernels'
roofline share over the strip whose searches were captured."""

from __future__ import annotations

MSAMPLE = 1 << 20
# the intersection kernels, by their names in the device trace
HIT = r"(?<![\w])hit_kernel\b"
MERGE = r"(?<![\w])hit_merge_kernel\b"
ANY = r"(?<![\w])any_kernel\b"


def ms_per_msample(run, device_us):
    """Device milliseconds per 2^20 camera samples of the profiled
    units; None where nothing ran under the range."""
    if run.profile is None or device_us <= 0:
        return None
    samples = run.samples_per_unit * run.profile.units
    return device_us / 1e3 / (samples / MSAMPLE)


def idle_share(run, unit_name):
    """Percent of the device-only traced window in which no device
    operation ran."""
    win = run.device_window
    if win is None or run.unit_name != unit_name or win.busy_s <= 0:
        return None
    return 100.0 * (1.0 - win.busy_s / win.window_s)


def capture_searches(run):
    """Record the inputs, answers and kernel launches of every search of
    the first strip traced in the profiled window. -> a callable that
    removes the hooks."""
    from yhair_tpu_torch.ops import intersect_kernel as ik
    from yhair_tpu_torch.parallel import mesh

    cap = run.cache.setdefault("searches", {"calls": [], "strip": 0})
    if "start" in cap:
        return None
    cap["start"] = dict(ik.LAUNCHES)
    nearest_hit, any_hit, trace_pixels = (ik.nearest_hit, ik.any_hit,
                                          mesh.trace_pixels)

    def nearest(o, d, cl):
        a = ik.LAUNCHES["hit_kernel"]
        out = nearest_hit(o, d, cl)
        if cap["strip"] <= 1:
            cap["calls"].append(("hit", o, d, None, out[0], cl, a,
                                 ik.LAUNCHES["hit_kernel"]))
        return out

    def occluded(o, d, t_max, cl):
        a = ik.LAUNCHES["any_kernel"]
        out = any_hit(o, d, t_max, cl)
        if cap["strip"] <= 1:
            cap["calls"].append(("any", o, d, t_max, out, cl, a,
                                 ik.LAUNCHES["any_kernel"]))
        return out

    def strip(*a, **kw):
        cap["strip"] += 1
        return trace_pixels(*a, **kw)
    ik.nearest_hit, ik.any_hit, mesh.trace_pixels = nearest, occluded, strip

    def undo():
        ik.nearest_hit, ik.any_hit, mesh.trace_pixels = (
            nearest_hit, any_hit, trace_pixels)
    return undo


def roofline(run, unit_name):
    """Percent: the least time of the captured searches' kernel work over
    the device time of their launches (hit + merge, any). None without a
    card, a capture, or a trace whose kernel events do not match the
    launches counted."""
    import torch

    from perfbench.counts import work

    cap = run.cache.get("searches")
    if (run.profile is None or run.unit_name != unit_name or not cap
            or not cap["calls"] or run.device.type != "cuda"):
        return None
    pk = work.peaks(torch.cuda.get_device_name(run.device))
    if pk is None:
        return None
    flop_s, bytes_s = pk
    ev = {"hit": run.profile.kernels(HIT), "merge": run.profile.kernels(MERGE),
          "any": run.profile.kernels(ANY)}
    start = cap["start"]
    least = spent = 0.0
    for kind, o, d, t_max, answer, cl, a, b in cap["calls"]:
        key = "hit_kernel" if kind == "hit" else "any_kernel"
        lo, hi = a - start[key], b - start[key]
        names = ("hit", "merge") if kind == "hit" else ("any",)
        if any(hi > len(ev[n]) for n in names) or hi <= lo:
            return None
        spent += sum((e - s) / 1e9 for n in names for s, e in ev[n][lo:hi])
        tests, n_bytes = (work.hit_work(o, d, answer, cl) if kind == "hit"
                          else work.any_work(o, d, t_max, answer, cl))
        least += work.least_seconds(kind, tests, n_bytes, flop_s, bytes_s)
    if spent <= 0:
        return None
    return 100.0 * least / spent
