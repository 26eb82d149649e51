"""Tests of the benchmark, on the CPU at tiny sizes (the `cuda` ones on
the card). Run from the repository's root:

    python -m pytest perfbench/tests -q
    python -m pytest perfbench/tests -q -m cuda      # on the card

This directory has its own conftest: tests/conftest.py imports JAX,
which nothing here may load.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def write_pfm(path, img):
    img = np.asarray(img, "<f4")
    h, w, _ = img.shape
    Path(path).write_bytes(f"PF\n{w} {h}\n-1.0\n".encode()
                           + img[::-1].tobytes())


def bench(src=ROOT):
    """BENCHMARK.json of a benchmark tree."""
    return json.loads((Path(src) / "BENCHMARK.json").read_text())


def cells(src=ROOT):
    """The cells of a benchmark tree, in BENCHMARK.json's order."""
    return [w["name"] for w in bench(src)["workloads"]]


def workload(src, cell):
    """A cell's workload file."""
    return json.loads((Path(src) / "perfbench" / "workloads"
                       / f"{cell}.json").read_text())


def driver(src, kind):
    from perfbench.lib import harness
    return harness.Layout(src).driver(kind)


def _need(mapping, key, where):
    if key not in mapping:
        raise KeyError(f"{where} has no {key!r} (perfbench/README.md, "
                       f"'Adding to it', says what each file carries)")
    return mapping[key]


def make_tiny_root(root: Path, src: Path = ROOT):
    """A copy of the benchmark tree ``src`` with every cell cut to its
    tests' size: each configuration's generator takes the arguments of
    its file's ``tiny`` key, each workload goes through its driver's
    ``tiny(workload)``. Drivers, metric files, scenes and data are
    ``src``'s (linked); ``data/tiny.pfm`` is a 16x16 target for the
    drivers whose tiny cells name it."""
    src = Path(src)
    bench_src = src / "perfbench"
    (root / "perfbench" / "configs").mkdir(parents=True)
    (root / "perfbench" / "workloads").mkdir()
    (root / "perfbench" / "data").mkdir()
    for sub in ("drivers", "metrics", "scenes"):
        (root / "perfbench" / sub).symlink_to(bench_src / sub)
    rng = np.random.default_rng(0)
    write_pfm(root / "perfbench" / "data" / "tiny.pfm",
              rng.random((16, 16, 3)) * 0.2)
    for f in (bench_src / "data").iterdir():
        if f.name != "tiny.pfm":
            (root / "perfbench" / "data" / f.name).symlink_to(f)
    b = bench(src)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    for c in b["configs"]:
        cfg = json.loads((src / c["file"]).read_text())
        cfg["generator"]["kwargs"] = _need(cfg, "tiny", src / c["file"])
        (root / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (root / c["file"]).write_text(json.dumps(cfg))
    for name in cells(src):
        path = bench_src / "workloads" / f"{name}.json"
        wl = json.loads(path.read_text())
        kind = _need(wl, "kind", path)
        tiny = _need(vars(driver(src, kind)), "tiny",
                     bench_src / "drivers" / f"{kind}.py")
        (root / "perfbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(tiny(wl)))
    return root


def tiny_scene(config, src=ROOT, kwargs=None):
    """A configuration's scene and camera dicts at its tests' size (or
    with the generator arguments ``kwargs``)."""
    import torch

    from perfbench.lib import harness
    layout = harness.Layout(src)
    cell = next(w["name"] for w in layout.bench["workloads"]
                if w["config"] == config)
    run = harness.Run(layout, cell, 1, torch.device("cpu"))
    run.config["generator"]["kwargs"] = kwargs or _need(
        run.config, "tiny", Path(src) / run.config_entry["file"])
    return run.scene()


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


def load_script(name):
    """perfbench/<name>.py as a module (its main is not called)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + name, ROOT / "perfbench" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="session")
def runmod():
    return load_script("run")


def run_tiny(runmod, root, cell, trace=0, seed=2**31 + 7, fault=None,
             control=False):
    """One CPU run of a tiny cell -> the parsed result line."""
    import time

    import torch

    from perfbench.lib import harness
    out = runmod.run_cell(harness.Layout(root), cell, seed, 0.2, trace,
                          torch.device("cpu"), time.perf_counter(),
                          fault=fault, control=control)
    return json.loads(out)
