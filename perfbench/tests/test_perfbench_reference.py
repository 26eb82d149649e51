"""The plain reference's searches against a brute-force scan, the work
count against the program's own lists, and the control (the reference
in bfloat16) against the cells' limits."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT, cells, run_tiny, tiny_scene


def _rays(n, seed=0, spread=0.6):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.15, (n, 3)) + [0.0, 0.25, 1.6]
    tgt = rng.normal(0, spread, (n, 3)) * [0.5, 0.5, 0.5]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, dtype=torch.float32),
            torch.as_tensor(d, dtype=torch.float32))


def _brute(o, d, sc, t_cap):
    """Every (ray, segment) capsule test -> (least s, least index at it,
    occluded below t_cap)."""
    from perfbench.reference.search import capsule_test
    p0, p1 = sc.p0[None], sc.p1[None]
    ok, s = capsule_test(o[:, None], d[:, None], p0.expand(len(o), -1, -1),
                         (p1 - p0).expand(len(o), -1, -1),
                         sc.r0[None].expand(len(o), -1),
                         (sc.r1 - sc.r0)[None].expand(len(o), -1),
                         _c(p1 - p0).expand(len(o), -1),
                         t_cap[:, None])
    s = torch.where(ok, s, 1e30)
    t = s.amin(1)
    idx = torch.where(ok & (s == t[:, None]),
                      torch.arange(s.shape[1])[None], 1 << 40).amin(1)
    return t, torch.where(t < 1e30, idx, 0), ok.any(1)


def _c(d2):
    return d2[..., 0] * d2[..., 0] + d2[..., 1] * d2[..., 1] \
        + d2[..., 2] * d2[..., 2]


def test_searches_equal_a_brute_force_scan():
    from perfbench.reference import scene as rscene
    from perfbench.reference import search
    scene_d, _ = tiny_scene("hairball3")
    sc = rscene.from_dict(scene_d, torch.device("cpu"))
    o, d = _rays(512)
    t, idx, hit = search.nearest(o, d, sc.groups)
    bt, bidx, _ = _brute(o, d, sc, torch.full((512,), 1e30))
    assert hit.any() and (~hit).any()
    assert torch.equal(t, bt) and torch.equal(idx, bidx)
    cap = torch.where(hit, t * 0.999, 1.0)
    occ = search.occluded(o, d, cap, sc.groups)
    _, _, bocc = _brute(o, d, sc, cap)
    assert torch.equal(occ, bocc)


def test_work_count_matches_the_programs_lists():
    """The nearest count is the clusters the program's list build keeps
    below each ray's answer; the any count is every cluster an unoccluded
    ray enters (one for a block of occluded rays), no more than the
    program's plain walk visits over its one-pass lists."""
    from yhair_tpu_torch.core import scene as tscene
    from yhair_tpu_torch.ops import build_scene_clusters
    from yhair_tpu_torch.ops import intersect_kernel as ik

    from perfbench.counts import work
    scene_d, _ = tiny_scene("hairball3", kwargs={
        "n_strands": 600, "n_seg": 4, "seed": 11})
    sc, cl = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                  device="cpu")
    o, d = _rays(1024, seed=3, spread=0.4)
    t, _, hit = ik.nearest_hit(o, d, cl)
    tests, _ = work.hit_work(o, d, t, cl)
    _, counts = ik._block_cluster_lists(o, d, cl, t_max=t)
    assert tests == int(counts.sum()) * 128 * 128 > 0
    t_max = torch.where(hit, t * 1.001, 0.5)
    occ = ik.any_hit(o, d, t_max, cl)
    assert occ.any() and (~occ).any()
    tests, _ = work.any_work(o, d, t_max, occ, cl)
    _, free = ik._block_cluster_lists(o, d, cl,
                                      t_max=torch.where(occ, -1.0, t_max))
    some = occ.view(-1, 128).any(1)
    need = torch.where((free == 0) & some, 1, free)
    assert tests == int(need.sum()) * 128 * 128 > 0
    ids, counts = ik._block_cluster_lists(o, d, cl, t_max=t_max)
    k_cap = ik._k_cap(cl.n_clusters)
    ids, counts = ik._pack_lists(ids, counts, k_cap, cl.n_clusters)
    _, walked = ik.any_pass_plain(o, d, t_max, ids, counts, cl.tc, k_cap,
                                  return_visits=True)
    assert (need <= walked).all()
    assert work.peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)


@pytest.mark.parametrize("cell", cells())
def test_control_fails_the_limits(runmod, tiny_root, cell):
    """The reference in bfloat16, in the program's place, comes out not
    correct through a run's own verdict."""
    out = run_tiny(runmod, tiny_root, cell, seed=5, control=True)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_fails_the_limits_on_the_card(runmod, card, cell):
    """The same at the cell's own size, on the card (a one-unit
    window)."""
    import time

    from perfbench.lib import harness
    runmod.configure(torch)
    out = json.loads(runmod.run_cell(harness.Layout(ROOT), cell, 11, 0.0,
                                     False, card, time.perf_counter(),
                                     control=True))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
