"""A run whose timed path is broken underneath reports correct: false.

Each run skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size, with one fault of perfbench/lib/faults.py
planted in the program."""

import json

import pytest

from conftest import ROOT, run_tiny

CELLS = [(c, f) for c in ("hairball3.fwdbwd-frame", "bunny5.invert-spec",
                          "hairball3.render-spec")
         for f in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("cell,fault", CELLS)
def test_fault_is_not_correct(runmod, tiny_root, cell, fault):
    from perfbench.lib.faults import planted
    kind = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json")
                      .read_text())["kind"]
    with planted(kind, fault) as wrap:
        out = run_tiny(runmod, tiny_root, cell, fault=wrap)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
