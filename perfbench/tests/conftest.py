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

TINY_SCENES = {"hairball3": {"n_strands": 200, "n_seg": 4, "seed": 11},
               "bunny5": {"n_strands": 300, "n_seg": 3, "seed": 17,
                          "subdiv": 1}}


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


def make_tiny_root(root: Path):
    """A benchmark tree like the repository's, with every cell cut to a
    32x32 image of a few hundred strands (drivers and metric files are
    the repository's)."""
    src = ROOT / "perfbench"
    (root / "perfbench" / "configs").mkdir(parents=True)
    (root / "perfbench" / "workloads").mkdir()
    (root / "perfbench" / "data").mkdir()
    for sub in ("drivers", "metrics"):
        (root / "perfbench" / sub).symlink_to(src / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["generator"]["kwargs"] = TINY_SCENES[c["name"]]
        (root / c["file"]).write_text(json.dumps(cfg))
    rng = np.random.default_rng(0)
    write_pfm(root / "perfbench" / "data" / "tiny.pfm",
              rng.random((16, 16, 3)) * 0.2)
    for w in bench["workloads"]:
        wl = json.loads((src / "workloads" / f"{w['name']}.json")
                        .read_text())
        wl.update(width=32, height=32, spp=2, max_depth=2)
        if wl["kind"] == "invert":
            wl["pixel_batch"] = wl["pixel_batch"] and 256
            wl["target"]["file"] = "tiny.pfm"
        else:
            wl["check_tiles"] = 2
        (root / "perfbench" / "workloads" / f"{w['name']}.json").write_text(
            json.dumps(wl))
    return root


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
