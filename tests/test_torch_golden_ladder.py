"""The port on the golden ladder's small rungs
(``tests/test_golden_ladder.py``).

Configs 1 and 2 re-render at their spec on the CPU through the port's
``progressive_render``, as ``render --config n`` builds them, and must
reproduce the committed TPU renders (``goldens/config{1,2}.pfm``) to
the reference test's unchanged gates: the mean within 2e-3 of the
golden's stats, every pixel within 5e-2, and more than 99% of the
values within 1e-3. Config 2 (8,000 segments, 128x128, 8 spp) is the
costly one: this file runs torch on 4 threads, which gives the same
image as 1 thread in a third of the time.
"""

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
