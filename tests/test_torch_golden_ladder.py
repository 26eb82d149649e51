"""The port on the golden ladder (``tests/test_golden_ladder.py``).

Configs 1 and 2 re-render at their spec on the CPU through the port's
``progressive_render``, as ``render --config n`` builds them, and must
reproduce the committed TPU renders (``goldens/config{1,2}.pfm``) to
the reference test's unchanged gates: the mean within 2e-3 of the
golden's stats, every pixel within 5e-2, and more than 99% of the
values within 1e-3. Config 2 (8,000 segments, 128x128, 8 spp) is the
costly one: this file runs torch on 4 threads, which gives the same
image as 1 thread in a third of the time.

Rungs 4 and 5 at their spec and config 5's inverse ran on an H100
through ``ladder_gpu.py``, which wrote ``goldens/torch/``; these tests
hold the committed artifacts to the reference's gates.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from scenes.generators import CONFIGS
from yhair_tpu_torch.apps import common
from yhair_tpu_torch.io import image as img_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "goldens")
TORCH_GOLD = os.path.join(GOLD, "torch")


@pytest.mark.parametrize("n", [1, 2])
def test_port_rerender_matches_golden(n):
    torch.set_num_threads(4)
    with open(os.path.join(GOLD, f"config{n}_stats.json")) as f:
        stats = json.load(f)
    gold = img_io.load_pfm(os.path.join(GOLD, f"config{n}.pfm"))
    cfg = CONFIGS[n]
    sc, cam = common.build_device_scene(*cfg["fn"](), accel="cluster",
                                        device="cpu")
    img = common.progressive_render(sc, cam, cfg["res"], cfg["res"],
                                    cfg["spp"], cfg["depth"], seed=0,
                                    log=None, device="cpu")
    assert np.isfinite(img).all()
    assert abs(img.mean() - stats["mean"]) < 2e-3 * max(1.0, stats["mean"])
    diff = np.abs(img - gold).max()
    assert diff < 5e-2, f"max pixel diff {diff}"
    close = np.isclose(img, gold, rtol=1e-3, atol=1e-3)
    assert close.mean() > 0.99, f"only {close.mean():.4f} of values close"


def _load(*path):
    with open(os.path.join(*path)) as f:
        return json.load(f)


def _reference_invert_argv():
    """``benchmarks/run_ladder.py:invert_config5``'s argv without the
    flags whose values are paths (the ones that are not literals)."""
    with open(os.path.join(ROOT, "benchmarks", "run_ladder.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "invert_config5")
    items = next(n.value.elts for n in ast.walk(fn)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "argv")
    argv, i = [], 0
    while i < len(items):
        if i + 1 < len(items) and not isinstance(items[i + 1], ast.Constant):
            i += 2
            continue
        argv.append(items[i].value)
        i += 1
    return argv


def test_port_config5_inverse_recovery():
    """The port's config-5 inverse at spec recovered the hair parameters
    to the reference's gates (``tests/test_golden_ladder.py:93-107``),
    from the reference's argv, on an H100, every step's loss kept."""
    rec = _load(TORCH_GOLD, "config5_recovered.json")
    for k in ("beta_m", "beta_n", "sigma_a"):
        true = np.asarray(rec["true"][k], np.float64)
        got = np.asarray(rec["recovered"][k], np.float64)
        err = np.abs(got - true) / np.maximum(np.abs(true), 1e-3)
        assert err.max() < 0.25, (k, true, got)
    assert rec["final_loss"] < 1e-3
    assert len(rec["losses"]) == rec["steps"] == 120
    assert rec["losses"][-1] == rec["final_loss"]
    assert np.isfinite(rec["losses"]).all()
    run = _load(TORCH_GOLD, "config5_run.json")
    assert run["invert_argv"] == _reference_invert_argv()
    assert run["render_argv"] == ["--config", "5"]
    assert "H100" in run["nvidia_smi"]


@pytest.mark.parametrize("n", [4, 5])
def test_port_spec_render_matches_golden_stats(n):
    """The port's render of config n at its spec on an H100 against the
    TPU's golden stats: the mean within 1%, the p99 luminance within 3%,
    finite."""
    got = _load(TORCH_GOLD, f"config{n}_stats.json")
    gold = _load(GOLD, f"config{n}_stats.json")
    assert [got[k] for k in ("res", "spp", "depth")] == [
        gold[k] for k in ("res", "spp", "depth")]
    assert got["finite"]
    assert abs(got["mean"] - gold["mean"]) <= 0.01 * gold["mean"]
    assert abs(got["p99_lum"] - gold["p99_lum"]) <= 0.03 * gold["p99_lum"]
    assert "H100" in got["nvidia_smi"]
