"""A run whose timed path is broken underneath reports correct: false.

Each run skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size, with one fault of its traffic kind
planted in the program: the driver's own ``FAULTS``, else the kind's
entry in perfbench/lib/faults.py."""

import pytest

from conftest import ROOT, cells, driver, run_tiny, workload


def faults_of(src, cell):
    """The names of the faults a cell's traffic kind can have."""
    from perfbench.lib import faults
    kind = workload(src, cell)["kind"]
    return list(getattr(driver(src, kind), "FAULTS", None)
                or faults.FAULTS[kind])


@pytest.mark.parametrize("cell,fault", [(c, f) for c in cells()
                                        for f in faults_of(ROOT, c)])
def test_fault_is_not_correct(runmod, tiny_root, cell, fault):
    from perfbench.lib.faults import planted
    kind = workload(tiny_root, cell)["kind"]
    with planted(kind, fault, driver(tiny_root, kind)) as wrap:
        out = run_tiny(runmod, tiny_root, cell, fault=wrap)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
