"""The benchmark of yhair_tpu_torch, one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. --trace 0 prints the cell's end-to-end
metrics; --trace 1 profiles whole units and prints its per-layer
metrics, the device's busy and window seconds (from units profiled with
the device's activity alone) and a breakdown. Every run
then checks the timed path's answers against the plain reference
(``perfbench/reference``) and prints each compared number beside its
limit, on standard error and under "checks" in the result line (the
last line of standard output). Needs a CUDA card: without one it exits
with 2 and prints no result. The files it reads are named in
perfbench/README.md.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402

PRELOADED = set(sys.modules)

import argparse  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths():
    """Import the benchmark as the package ``perfbench`` and the program
    from the checkout's root, not from this script's directory."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    # the program's build caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / ".perfbench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / ".perfbench_cache" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    _paths()
    import torch

    from perfbench.lib import harness

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    layout = harness.Layout(ROOT)
    chips = layout.cell(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    configure(torch)
    out = run_cell(layout, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        new = sorted(set(found) - {m.split(".")[0] for m in PRELOADED})
        print(f"perfbench: modules that must not load are loaded: {found} "
              f"(loaded during this run: {new})", file=sys.stderr)
        return 3
    print(out)
    return 0


def configure(torch):
    """One host thread for the program's CPU operations, so that no
    worker pool competes with the thread that drives the card; float32
    matmuls without TF32."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_cell(layout, cell, seed, seconds, trace, dev, t_start, fault=None,
             control=False):
    """Set up, measure, check. -> the result line (a JSON string); the
    checks are also printed to standard error. fault: a wrapper of the
    timed path (lib/faults.py). control: judge the plain reference in the
    precision below the configuration's, put in the program's place for
    the same units, instead of the program's answers (control.py)."""
    import torch

    from perfbench.lib import harness, profiling

    run = harness.Run(layout, cell, seed, dev)
    run.note("imports and files (since start)", t_start)
    e2e, per_layer = layout.metrics_of(cell)
    readers = {m["name"]: layout.metric(m["name"])
               for m in (per_layer if trace else e2e)}
    cuda = dev.type == "cuda"
    if cuda:
        t0 = harness.now()
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        run.note("CUDA start", t0)
    st = run.driver.setup(run, fault=fault)
    if cuda:
        torch.cuda.synchronize(dev)
    run.setup_s = harness.now() - t_start

    def unit(k):
        t0 = harness.now()
        run.driver.unit(st, k)
        run.unit_s.append(harness.now() - t0)

    with harness.steady():
        if trace:
            n = run.workload["trace_units"]
            run.device_window = profiling.device_window(unit, 0, n, dev)
            undo = [r.prepare(run) for r in readers.values()
                    if hasattr(r, "prepare")]
            try:
                run.profile = profiling.profile_units(unit, n, n, dev)
            finally:
                for u in undo:
                    if u is not None:
                        u()
            run.units = 2 * n
            run.window_s = run.device_window.window_s + run.profile.window_s
        else:
            t0 = harness.now()
            while True:
                unit(run.units)
                run.units += 1
                if harness.now() - t0 >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize(dev)
            run.window_s = harness.now() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    t_read = harness.now()
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = readers[m["name"]].read(run)
        if harness.finite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = run.driver.failed_units(st)
    run.driver.release(st)
    if cuda:
        torch.cuda.empty_cache()
    t_check = harness.now()
    if control:
        readings = run.driver.control(run, st,
                                      harness.control_dtype(run.config))
    else:
        readings = run.driver.check(run, st)
    print(f"perfbench: set-up {run.setup_s:.1f} s, window "
          f"{run.window_s:.1f} s, metrics {t_check - t_read:.1f} s, "
          f"check {harness.now() - t_check:.1f} s; unit seconds "
          f"{' '.join(f'{x:.3f}' for x in run.unit_s)}", file=sys.stderr)
    checks, correct = harness.verdict(readings, run.workload["limits"],
                                      failed)
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        device["busy_s"] = run.device_window.busy_s
        device["window_s"] = run.device_window.window_s
        breakdown = {"device_ops": run.device_window.device_ops(),
                     "idle_gaps": run.profile.idle_gaps()}
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return harness.result_line(correct, run.units, failed, metrics, device,
                               breakdown, checks)


if __name__ == "__main__":
    sys.exit(main())
