"""The frozen inputs under perfbench/ equal what they were copied from."""

import importlib.util

import numpy as np
import pytest

from conftest import ROOT


def _frozen():
    spec = importlib.util.spec_from_file_location(
        "frozen_generators", ROOT / "perfbench" / "scenes" / "generators.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("fn,kwargs", [
    ("curly_hairball", {"n_strands": 10000, "n_seg": 12, "seed": 11}),
    ("furry_bunny", {"n_strands": 50000, "n_seg": 6, "seed": 17,
                     "subdiv": 2}),
])
def test_generators_equal_the_originals(fn, kwargs):
    from scenes import generators
    frozen = getattr(_frozen(), fn)(**kwargs)
    original = getattr(generators, fn)(**kwargs)
    assert _equal(frozen, original)


@pytest.mark.parametrize("name", ["config3.pfm", "config5.pfm"])
def test_targets_are_the_goldens(name):
    assert ((ROOT / "perfbench" / "data" / name).read_bytes()
            == (ROOT / "goldens" / name).read_bytes())
