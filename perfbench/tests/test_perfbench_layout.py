"""Files found by name, the result line, the counted rays, the import
check, and a tiny run of every cell on the CPU."""

import json

import pytest

from conftest import ROOT, cells, driver, make_tiny_root, run_tiny, workload

# the counts PERF.md cites; a cell not named here is held to its files
DOCUMENTED = {"hairball3.fwdbwd-frame": 3_145_728,
              "bunny5.invert-spec": 2_359_296,
              "hairball3.render-spec": 18_874_368,
              "bunny5.render-pass": 18_874_368}


def counted_rays(src, cell):
    """Camera samples a unit x depth x rays a bounce casts, from the
    cell's workload and configuration files."""
    from perfbench.lib import harness
    wl = workload(src, cell)
    _, cfg = harness.Layout(src).config(wl["config"])
    return (driver(src, wl["kind"]).samples_per_unit(wl) * wl["max_depth"]
            * cfg["rays_per_bounce"])


@pytest.mark.parametrize("cell,rays", [(c, counted_rays(ROOT, c))
                                       for c in cells()])
def test_counted_rays_per_unit(cell, rays):
    import torch

    from perfbench.lib import harness
    run = harness.Run(harness.Layout(ROOT), cell, 1, torch.device("cpu"))
    assert run.rays_per_unit == rays == DOCUMENTED.get(cell, rays)


@pytest.mark.parametrize("mods,found", [
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["yhair_tpu.core.scene"], ["yhair_tpu"]),
    (["flax"], ["flax"]),
    (["yhair_tpu_torch", "yhair_tpu_torch.ops", "jaxtyping"], []),
])
def test_import_check(mods, found):
    from perfbench.lib import harness
    assert harness.forbidden_modules(mods) == found


def test_nothing_forbidden_after_a_run(runmod, tiny_root):
    import sys

    from perfbench.lib import harness
    run_tiny(runmod, tiny_root, "hairball3.render-spec")
    assert harness.forbidden_modules(sys.modules) == []


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run(runmod, tiny_root, cell, trace):
    from perfbench.lib import harness
    out = run_tiny(runmod, tiny_root, cell, trace)
    assert list(out) == (["correct", "attempted", "failed", "metrics",
                          "device"] + (["breakdown"] if trace else [])
                         + ["checks"])
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    names = set(out["metrics"])
    if trace:
        assert "scene_build_s" in names
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        e2e, _ = harness.Layout(tiny_root).metrics_of(cell)
        assert {m["name"] for m in e2e} == names
        assert "setup_s" in names and len(names) >= 2
    limits = workload(tiny_root, cell)["limits"]
    assert out["checks"] and set(out["checks"]) == set(limits)
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_new_cell_config_and_metric_by_name(runmod, tmp_path):
    """A cell, a configuration and a per-layer metric added as new files
    and entries, no existing file edited."""
    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "perfbench/configs/hairball3.json").read_text())
    cfg["generator"]["kwargs"]["n_strands"] = 150
    (root / "perfbench/configs/hairball3b.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "perfbench/workloads/hairball3.render-spec.json")
                    .read_text())
    wl.update(config="hairball3b", traffic="render-tiny", spp=1)
    (root / "perfbench/workloads/hairball3b.render-tiny.json").write_text(
        json.dumps(wl))
    metrics = root / "perfbench" / "metrics2"
    metrics.mkdir()
    for f in (ROOT / "perfbench" / "metrics").glob("*.py"):
        (metrics / f.name).symlink_to(f)
    (metrics / "units_traced.py").write_text(
        "def read(run):\n    return run.profile.units\n")
    (root / "perfbench" / "metrics").unlink()
    metrics.rename(root / "perfbench" / "metrics")
    bench["configs"].append(dict(bench["configs"][0], name="hairball3b",
                                 file="perfbench/configs/hairball3b.json"))
    bench["workloads"].append({"name": "hairball3b.render-tiny",
                               "config": "hairball3b",
                               "traffic": "render-tiny", "chips": 1,
                               "why": "a throwaway cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "render_mrays_s":
            m["workloads"].append("hairball3b.render-tiny")
    bench["per_layer"].append({"name": "units_traced", "unit": "units",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "render_mrays_s",
                               "workloads": ["hairball3b.render-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_tiny(runmod, root, "hairball3b.render-tiny", trace=1)
    assert out["correct"] is True
    assert out["metrics"]["units_traced"]["value"] == 1
    out = run_tiny(runmod, root, "hairball3b.render-tiny", trace=0)
    assert "render_mrays_s" in out["metrics"]
