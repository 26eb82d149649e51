"""A configuration, a traffic kind, a cell and a per-layer metric added to
a copy of the benchmark tree as new files and new entries only, no
existing file edited; then the existing tests' own functions run on the
new cell: tiny runs at trace 0 and 1, the control and every fault of the
new kind failing the limits, the frozen generator against its original,
and the parametrisations finding each new piece by name."""

import hashlib
import json
import shutil
import textwrap

import test_perfbench_faults as faults_tests
import test_perfbench_frozen as frozen_tests
import test_perfbench_layout as layout_tests
import test_perfbench_program as program_tests
import test_perfbench_reference as reference_tests
from conftest import ROOT, cells, make_tiny_root, run_tiny

CELL = "patch2.preview"

# a configuration: config 2's hair patch, its generator a frozen copy in
# a scene file of its own
SCENE = '''
from pathlib import Path

import numpy as np

from perfbench.lib.harness import load_file_module

_g = load_file_module(Path(__file__).with_name("generators.py"), "scene")


def hair_patch(n_strands=1000, n_seg=8, seed=7):
    rng = np.random.default_rng(seed)
    roots = np.stack([rng.uniform(-0.5, 0.5, n_strands),
                      np.full(n_strands, -0.4),
                      rng.uniform(-0.15, 0.15, n_strands)], axis=-1)
    sway = rng.normal(0, 0.08, (n_strands, 2, 3))
    length = rng.uniform(0.5, 0.8, n_strands)[:, None]
    up = np.array([0.0, 1.0, 0.0])
    cp = np.stack([
        roots,
        roots + up * length * 0.33 + sway[:, 0] * [1, 0.2, 1],
        roots + up * length * 0.66 + sway[:, 1] * [1, 0.2, 1],
        roots + up * length + sway[:, 0] * [0.5, 0.1, 0.5],
    ], axis=1)
    segs = _g._strands_to_segments(cp, np.full(n_strands, 0.004),
                                   np.full(n_strands, 0.0015), n_seg=n_seg)
    scene = {
        "segments": segs,
        "hair_material": dict(_g.DEFAULT_HAIR),
        "point_lights": [
            {"position": [1.5, 1.5, 2.5], "intensity": [18.0, 18.0, 18.0]},
        ],
        "environment": np.array([0.08, 0.09, 0.11]),
        "planes": [{"point": [0.0, -0.42, 0.0], "normal": [0.0, 1.0, 0.0],
                    "albedo": [0.4, 0.38, 0.35]}],
    }
    return scene, _g._camera([0.0, 0.2, 1.9], [0.0, 0.0, 0.0])
'''

CONFIG = {"name": "patch2",
          "generator": {"module": "patch", "function": "hair_patch",
                        "kwargs": {"n_strands": 1000, "n_seg": 8, "seed": 7}},
          "rays_per_bounce": 2, "precision": "float32",
          "tiny": {"n_strands": 60, "n_seg": 4, "seed": 7},
          "reduced": [], "assumed": []}

# a traffic kind: whole images as the render kind makes them, with its
# own tests' size and its own faults
DRIVER = '''
"""Traffic kind ``preview``: the render kind's images, cut smaller for
the tests, with faults of its own."""

from pathlib import Path

import numpy as np

from perfbench.lib import faults
from perfbench.lib.harness import load_file_module

_render = load_file_module(Path(__file__).with_name("render.py"), "driver")
UNIT = _render.UNIT
samples_per_unit = _render.samples_per_unit
setup, unit, release = _render.setup, _render.unit, _render.release
failed_units, check, control = (_render.failed_units, _render.check,
                                _render.control)


def tiny(w):
    return dict(w, width=16, height=16, spp=1, max_depth=2, check_tiles=1)


def _dimmed(render):
    def run(*a, **kw):
        return np.asarray(render(*a, **kw)) * 0.95
    return run


FAULTS = {"dimmed": (_dimmed, None),
          "half": faults.FAULTS["render"]["half"]}
'''

WORKLOAD = {"config": "patch2", "traffic": "preview", "kind": "preview",
            "why": "a throwaway cell", "width": 64, "height": 64, "spp": 1,
            "max_depth": 4, "check_tiles": 4, "trace_units": 1,
            "limits": {"image_gap": 1e-3}}

# a per-layer metric: the program's own spans of one pass, counted in
# the traced window
METRIC = '''
from perfbench.lib.program import prepare  # noqa: F401


def read(run):
    return sum(1 for *_, n in run.profile.host if n == "yhair.pass")
'''


def _digests(tree):
    return {p.relative_to(tree): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file()}


def _add(tree):
    """The new files and entries; -> the digests of what was there."""
    shutil.copytree(ROOT / "perfbench", tree / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tree / "BENCHMARK.json")
    before = _digests(tree)
    pb = tree / "perfbench"
    (pb / "scenes" / "patch.py").write_text(textwrap.dedent(SCENE))
    (pb / "configs" / "patch2.json").write_text(json.dumps(CONFIG))
    (pb / "drivers" / "preview.py").write_text(DRIVER)
    (pb / "workloads" / f"{CELL}.json").write_text(json.dumps(WORKLOAD))
    (pb / "metrics" / "render_passes.py").write_text(METRIC)
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "patch2", "source": "a test",
                             "file": "perfbench/configs/patch2.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "patch2",
                               "traffic": "preview", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "render_mrays_s":
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "render_passes", "unit": "passes",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "progressive render",
                               "moves": "render_mrays_s",
                               "workloads": [CELL]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    return before


def _entries_kept(old, new):
    """Every entry of the old BENCHMARK.json is in the new one as it
    was, apart from names added to a metric's ``workloads``."""
    for key, items in old.items():
        if not (isinstance(items, list)
                and all(isinstance(x, dict) for x in items)):
            assert new[key] == items
            continue
        for item in items:
            twin = next(x for x in new[key] if x.get("name") ==
                        item.get("name"))
            if "workloads" in item:
                assert twin["workloads"][:len(item["workloads"])] \
                    == item["workloads"]
                twin = dict(twin, workloads=item["workloads"])
            assert twin == item


def test_new_configuration_kind_and_cell_as_new_files(runmod, tmp_path):
    tree = tmp_path / "tree"
    before = _add(tree)
    after = _digests(tree)
    edited = [p for p, d in before.items()
              if after[p] != d and p.name != "BENCHMARK.json"]
    assert edited == []
    _entries_kept(json.loads((ROOT / "BENCHMARK.json").read_text()),
                  json.loads((tree / "BENCHMARK.json").read_text()))

    # the parametrisations find each new piece by name
    assert cells(tree)[-1] == CELL
    assert faults_tests.faults_of(tree, CELL) == ["dimmed", "half"]
    assert ("patch", "hair_patch",
            CONFIG["generator"]["kwargs"]) in frozen_tests.frozen_cases(tree)
    assert (CELL, "search_live_share.render") in \
        program_tests.live_share_cases(tree)
    assert layout_tests.counted_rays(tree, CELL) == 64 * 64 * 1 * 4 * 2

    # the existing tests' functions, on the new cell
    frozen_tests.generator_equals_the_original(
        "patch", "hair_patch", {"n_strands": 40, "n_seg": 3, "seed": 5},
        src=tree)
    tiny = make_tiny_root(tmp_path / "tiny", src=tree)
    for trace in (0, 1):
        layout_tests.test_tiny_run(runmod, tiny, CELL, trace)
    reference_tests.test_control_fails_the_limits(runmod, tiny, CELL)
    for fault in faults_tests.faults_of(tree, CELL):
        faults_tests.test_fault_is_not_correct(runmod, tiny, CELL, fault)
    program_tests.test_traced_tiny_run_counts_the_lanes(runmod, tiny, CELL)

    # the new metric, in the traced window
    out = run_tiny(runmod, tiny, CELL, trace=1)
    assert out["metrics"]["render_passes"]["value"] == 1


def test_missing_tiny_is_named(tmp_path):
    """A configuration file without ``tiny``: the tiny tree's error names
    the file and the key."""
    import pytest
    tree = tmp_path / "tree"
    _add(tree)
    cfg = tree / "perfbench" / "configs" / "patch2.json"
    cfg.write_text(json.dumps({k: v for k, v in CONFIG.items()
                               if k != "tiny"}))
    with pytest.raises(KeyError, match=r"patch2\.json.*'tiny'"):
        make_tiny_root(tmp_path / "tiny", src=tree)
