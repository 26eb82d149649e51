"""The CUDA kernels against their plain torch versions, on a card.

Needs an NVIDIA card and nvcc (marker ``cuda``); skips without a card.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Inputs are the small hairball's clusters and random rays made with
numpy from a seed. Kernel and plain version do the same arithmetic in
the same order (the kernels are built without FMA contraction), so
their outputs are compared bit for bit.
"""

import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.ops import build_scene_clusters
from yhair_tpu_torch.ops import intersect_kernel as ik

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def clusters():
    scene_d, _ = gen.curly_hairball(n_strands=300, n_seg=8)
    _, cl = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                 device="cpu")
    return cl


def _pass_inputs(cl, dev, seed, n=1024):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 2.0
    d = rng.normal(size=(n, 3)) * 0.2 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.as_tensor(o, dtype=torch.float32)
    d = torch.as_tensor(d, dtype=torch.float32)
    ids, counts = ik._block_cluster_lists(o, d, cl)
    k_cap = ik._k_cap(cl.n_clusters)
    ids, counts = ik._pack_lists(ids, counts, k_cap, cl.n_clusters)
    return [x.to(dev) for x in (o, d, ids, counts, cl.tc)] + [k_cap]


@pytest.mark.parametrize("k_cap", [None, 4])
def test_hit_kernel_matches_plain(clusters, cuda, k_cap):
    """k_cap 4 sends the longer lists as the scan-everything sentinel."""
    o, d, ids, counts, tc, full_cap = _pass_inputs(clusters, cuda, 9)
    k_cap = k_cap or full_cap
    ids, counts = ik._pack_lists(ids, counts, k_cap, clusters.n_clusters)
    n = o.shape[0]
    seeds = (torch.full((n,), ik.INF, device=cuda),
             torch.zeros(n, dtype=torch.int32, device=cuda),
             torch.full((n,), ik.NO_ID, device=cuda))
    before = ik.LAUNCHES["hit_kernel"]
    got = ik.hit_pass(o, d, seeds, ids, counts, tc, k_cap)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["hit_kernel"] == before + 1
    want = ik.hit_pass_plain(o, d, seeds, ids, counts, tc, k_cap)
    assert (got[0] < ik.INF).sum() > 100
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k_cap", [None, 4])
def test_any_kernel_matches_plain(clusters, cuda, k_cap):
    o, d, ids, counts, tc, full_cap = _pass_inputs(clusters, cuda, 10)
    k_cap = k_cap or full_cap
    ids, counts = ik._pack_lists(ids, counts, k_cap, clusters.n_clusters)
    t_cap = torch.as_tensor(
        np.random.default_rng(11).uniform(0.5, 4.0, o.shape[0]),
        dtype=torch.float32, device=cuda)
    before = ik.LAUNCHES["any_kernel"]
    got = ik.any_pass(o, d, t_cap, ids, counts, tc, k_cap)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["any_kernel"] == before + 1
    want = ik.any_pass_plain(o, d, t_cap, ids, counts, tc, k_cap)
    assert got.sum() > 50
    assert torch.equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(clusters, cuda):
    o, d, ids, counts, tc, k_cap = _pass_inputs(clusters, cuda, 12)
    with pytest.raises(ValueError):
        ik.any_pass(o[:100], d[:100], torch.ones(100, device=cuda), ids,
                    counts, tc, k_cap)
    with pytest.raises(ValueError):
        ik.any_pass(o, d, torch.ones(o.shape[0], device=cuda,
                                     dtype=torch.float64), ids, counts, tc,
                    k_cap)
