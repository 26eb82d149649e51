"""One run of one cell: find its files by name, set up, measure, check,
print.

Everything that belongs to one cell, configuration, traffic kind or
metric lives in a file of its own, found by the names in
``BENCHMARK.json``:

- ``perfbench/workloads/<cell>.json``: the cell's traffic (its kind,
  sizes, step or image parameters) and the limits of its checks;
- the configuration's ``file`` (``perfbench/configs/<config>.json``):
  the scene's generator (a function of ``perfbench/scenes/<module>.py``
  and its arguments) and the rays each bounce casts;
- ``perfbench/drivers/<kind>.py``: set-up, one timed unit, the answers
  and their check;
- ``perfbench/metrics/<metric>.py``: ``read(run)`` -> a number or None,
  and optionally ``prepare(run)`` (hooks for the traced run, returning
  a callable that removes them).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "yhair_tpu")
# the control's precision: the nearest below the one a configuration
# states, in which the tracer's arithmetic (elementwise, no matmul, so
# TF32 changes nothing) can run
LOWER = {"float64": "float32", "float32": "bfloat16"}


def load_file_module(path: Path, tag: str):
    """Import a file by its path under a private module name."""
    name = "perfbench_" + tag + "_" + "".join(
        ch if ch.isalnum() else "_" for ch in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole (``yhair_tpu_torch`` is not ``yhair_tpu``)."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".")[0] for m in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Layout:
    """Where a benchmark's files are: ``root`` holds ``BENCHMARK.json``
    and ``perfbench/`` with the data directories."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "perfbench"

    def cell(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.bench["configs"]:
            if c["name"] == name:
                return c, json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def workload(self, name):
        return json.loads((self.dir / "workloads" / f"{name}.json")
                          .read_text())

    def driver(self, kind):
        return load_file_module(self.dir / "drivers" / f"{kind}.py",
                                "driver")

    def metric(self, name):
        return load_file_module(self.dir / "metrics" / f"{name}.py",
                                "metric")

    def data(self, name):
        return self.dir / "data" / name

    def metrics_of(self, cell_name):
        """(end-to-end entries, per-layer entries) the cell reports: an
        entry with ``workloads`` where it lists the cell; an end-to-end
        entry without it everywhere; a per-layer one without it wherever
        the end-to-end metric it moves is reported."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell_name in m.get("workloads", [cell_name])]
        names = {m["name"] for m in e2e}
        per = [m for m in self.bench["per_layer"]
               if (cell_name in m["workloads"] if "workloads" in m
                   else m["moves"] in names)]
        return e2e, per


class Run:
    """What one run measured, read by the metric files."""

    def __init__(self, layout, cell_name, seed, device):
        self.layout = layout
        self.cell = layout.cell(cell_name)
        self.name = cell_name
        self.config_entry, self.config = layout.config(self.cell["config"])
        self.workload = layout.workload(cell_name)
        if (self.workload["config"] != self.cell["config"]
                or self.workload["traffic"] != self.cell["traffic"]):
            raise ValueError(f"{cell_name}.json names another config or "
                             f"traffic than BENCHMARK.json")
        self.seed = int(seed)
        self.device = device
        self.driver = layout.driver(self.workload["kind"])
        self.unit_name = self.driver.UNIT
        self.samples_per_unit = self.driver.samples_per_unit(self.workload)
        self.rays_per_unit = (self.samples_per_unit
                              * self.workload["max_depth"]
                              * self.config["rays_per_bounce"])
        self.setup_s = self.scene_build_s = None
        self.units = 0
        self.window_s = None
        self.unit_s = []          # each measured unit's seconds
        self.device_window = None  # lib.profiling.DeviceWindow, traced
        self.profile = None       # lib.profiling.Profile of a traced run
        self.cache = {}           # shared by metric files

    def note(self, what, t0):
        """One line of set-up timing on standard error."""
        print(f"perfbench: {what} {now() - t0:.2f} s", file=sys.stderr)

    def scene(self):
        """The configuration's scene dict and camera dict, from its
        frozen generator."""
        gen = self.config["generator"]
        mod = load_file_module(
            self.layout.dir / "scenes" / f"{gen['module']}.py", "scene")
        return getattr(mod, gen["function"])(**gen.get("kwargs", {}))

    def target(self):
        """The workload's target image, (height, width, 3) float32: a
        PFM of ``perfbench/data`` box-upsampled by whole factors."""
        t = self.workload["target"]
        img = read_pfm(self.layout.data(t["file"]))
        fy = self.workload["height"] // img.shape[0]
        fx = self.workload["width"] // img.shape[1]
        if (img.shape[0] * fy, img.shape[1] * fx) != (
                self.workload["height"], self.workload["width"]):
            raise ValueError("the target does not upsample to the image")
        return np.repeat(np.repeat(img, fy, 0), fx, 1)


def read_pfm(path):
    """(H, W, 3) float32 from a colour PFM, top row first."""
    raw = Path(path).read_bytes()
    parts = raw.split(b"\n", 3)
    if parts[0].strip() != b"PF":
        raise ValueError(f"{path}: not a colour PFM")
    w, h = (int(x) for x in parts[1].split())
    scale = float(parts[2])
    dt = "<f4" if scale < 0 else ">f4"
    data = np.frombuffer(parts[3], dtype=dt, count=w * h * 3)
    return np.ascontiguousarray(data.reshape(h, w, 3)[::-1]).astype(
        np.float32)


def control_dtype(config):
    """The dtype of the control for a configuration file's precision."""
    import torch
    return getattr(torch, LOWER[config["precision"]])


def verdict(readings, limits, failed):
    """-> ({name: {"value", "limit"}}, correct): every reading finite and
    at most its limit, and no failed unit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    correct = failed == 0 and all(
        finite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return checks, correct


@contextmanager
def steady():
    """The measured window without the cyclic garbage collector: what
    set-up left is frozen out of its generations, and no collection
    stops the host mid-window."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def result_line(correct, attempted, failed, metrics, device, breakdown=None,
                checks=None):
    """The last line of standard output: the required keys, then the
    compared numbers under a key of their own, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks or {}
    return json.dumps(out)


def finite(x):
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


def now():
    return time.perf_counter()
