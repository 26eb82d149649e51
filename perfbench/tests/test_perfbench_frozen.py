"""The frozen inputs under perfbench/ equal what they were copied from:
each configuration's generator, where ``scenes/generators.py`` has a
function of its name, and each workload's target, against
``goldens/``."""

import numpy as np
import pytest

from conftest import ROOT, bench, cells, workload


def frozen_cases(src=ROOT):
    """(module, function, kwargs) of each configuration whose generator
    has a namesake in the repository's scenes/generators.py."""
    import json

    from scenes import generators
    out = []
    for c in bench(src)["configs"]:
        gen = json.loads((src / c["file"]).read_text())["generator"]
        if hasattr(generators, gen["function"]):
            out.append((gen["module"], gen["function"], gen["kwargs"]))
    return out


def target_files(src=ROOT):
    """Each target file a workload names, once."""
    names = [workload(src, c).get("target", {}).get("file")
             for c in cells(src)]
    return sorted({n for n in names if n})


def _frozen(src, module):
    from perfbench.lib.harness import load_file_module
    return load_file_module(src / "perfbench" / "scenes" / f"{module}.py",
                            "frozen")


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def generator_equals_the_original(module, fn, kwargs, src=ROOT):
    from scenes import generators
    frozen = getattr(_frozen(src, module), fn)(**kwargs)
    original = getattr(generators, fn)(**kwargs)
    assert _equal(frozen, original)


CASES = frozen_cases()


@pytest.mark.parametrize("module,fn,kwargs", CASES,
                         ids=[f"{fn}-kwargs{k}"
                              for k, (_, fn, _) in enumerate(CASES)])
def test_generators_equal_the_originals(module, fn, kwargs):
    generator_equals_the_original(module, fn, kwargs)


@pytest.mark.parametrize("name", target_files())
def test_targets_are_the_goldens(name):
    assert ((ROOT / "perfbench" / "data" / name).read_bytes()
            == (ROOT / "goldens" / name).read_bytes())
