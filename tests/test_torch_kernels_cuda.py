"""The CUDA kernels against their plain torch versions, on a card.

Needs an NVIDIA card and nvcc (marker ``cuda``); skips without a card.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Inputs are the small hairball's clusters (a larger one where a list of
hundreds of clusters is needed) and rays made with numpy from a seed.
Kernel and plain version do the same arithmetic in the same order (the
kernels are built without FMA contraction), so their outputs are
compared bit for bit, whatever order the kernels' work items ran in.
"""

import numpy as np
import pytest
import torch

import test_torch_triangle_search as tts
from scenes import generators as gen
from yhair_tpu_torch import kernels
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.geometry import triangles as tri
from yhair_tpu_torch.ops import build_scene_clusters
from yhair_tpu_torch.ops import intersect_kernel as ik

pytestmark = pytest.mark.cuda

# the LAUNCHES keys of the cluster search and of the triangle search
CLUSTER_KERNELS = ("lists_kernel", "hit_kernel", "any_kernel")
TRIANGLE_KERNELS = ("tri_hit_kernel", "tri_any_kernel")


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


@pytest.fixture(scope="module")
def big_clusters():
    scene_d, _ = gen.curly_hairball(n_strands=3000, n_seg=8)
    _, cl = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                 device="cpu")
    assert cl.n_clusters >= 256
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


def _no_seeds(n, dev):
    return (torch.full((n,), ik.INF, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.full((n,), ik.NO_ID, device=dev))


def _check_hit(o, d, seeds, ids, counts, tc, k_cap):
    before = ik.LAUNCHES["hit_kernel"]
    got = ik.hit_pass(o, d, seeds, ids, counts, tc, k_cap)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["hit_kernel"] == before + 1
    ids, counts = ik._pack_lists(ids, counts, k_cap, tc.shape[0])
    want = ik.hit_pass_plain(o, d, seeds, ids, counts, tc, k_cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


def _check_any(o, d, t_cap, ids, counts, tc, k_cap):
    """-> (occ, the kernel's visits, the sequential walk's visits)."""
    visits = torch.empty(counts.shape, dtype=torch.int32, device=o.device)
    got = ik.any_pass(o, d, t_cap, ids, counts, tc, k_cap, visits=visits)
    torch.cuda.synchronize()
    ids, counts = ik._pack_lists(ids, counts, k_cap, tc.shape[0])
    want, need = ik.any_pass_plain(o, d, t_cap, ids, counts, tc, k_cap,
                                   return_visits=True)
    assert torch.equal(got, want)
    return got, visits, need


@pytest.mark.parametrize("k_cap", [None, 4])
@pytest.mark.parametrize("kind", ["hit", "any"])
def test_long_list_beside_short_ones(big_clusters, cuda, kind, k_cap):
    """Block 0 lists every cluster, block 1 one, block 2 none, block 3
    its own front-to-back list; k_cap 4 sends blocks 0 and 3 as the
    sentinel."""
    cl = big_clusters
    c = cl.n_clusters
    o, d, ids, counts, tc, full_cap = _pass_inputs(cl, cuda, 20, n=512)
    k_cap = k_cap or full_cap
    rows = torch.zeros((4, full_cap), dtype=torch.int32, device=cuda)
    rows[0, :c] = torch.as_tensor(np.random.default_rng(21).permutation(c),
                                  dtype=torch.int32)
    rows[1, 0] = ids[1, 0]
    rows[3] = ids[3]
    counts = torch.tensor([c, 1, 0, int(counts[3])], dtype=torch.int32,
                          device=cuda)
    assert int(counts[3]) > 4
    if kind == "hit":
        got = _check_hit(o, d, _no_seeds(512, cuda), rows, counts, tc,
                         k_cap)
        assert (got[0][:128] < ik.INF).sum() > 10
    else:
        t_cap = torch.full((512,), 3.0, device=cuda)
        got, _, _ = _check_any(o, d, t_cap, rows, counts, tc, k_cap)
        assert got[:128].sum() > 10


def test_pass_two_with_seeds(clusters, cuda):
    """A pass-2 launch: seeds from a prefix pass, the rest of the lists."""
    o, d, ids, counts, tc, k_cap = _pass_inputs(clusters, cuda, 22)
    seeds = ik.hit_pass_plain(o, d, _no_seeds(o.shape[0], cuda),
                              *ik._pack_lists(ids[:, :3],
                                              torch.clamp(counts, max=3),
                                              128, clusters.n_clusters),
                              tc, 128)
    assert (seeds[0] < ik.INF).sum() > 20
    got = _check_hit(o, d, seeds, ids[:, 3:], torch.clamp(counts - 3, min=0),
                     tc, k_cap)
    assert (got[0] < seeds[0]).sum() > 0


def _aimed(cl, dev, n_blocks, seed):
    """Each block's rays come from one side at the midpoints of one
    cluster's segments; its list puts that cluster first, then every
    other cluster. -> o, d, ids, counts."""
    rng = np.random.default_rng(seed)
    c = cl.n_clusters
    full = np.flatnonzero((cl.seg_index.numpy().reshape(c, 128) >= 0)
                          .all(1))
    first = rng.choice(full, n_blocks, replace=False)
    seg = (first[:, None] * 128 + np.arange(128)).reshape(-1)
    mid = 0.5 * (cl.s0[seg, :3] + cl.s1[seg, :3]).numpy()
    u = np.repeat(rng.normal(size=(n_blocks, 3)), 128, axis=0)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    ids = np.stack([np.concatenate([[f], np.delete(np.arange(c), f)])
                    for f in first]).astype(np.int32)
    t = (torch.as_tensor(mid + 3.0 * u, dtype=torch.float32),
         torch.as_tensor(-u, dtype=torch.float32), torch.as_tensor(ids),
         torch.full((n_blocks,), c, dtype=torch.int32))
    return [x.to(dev) for x in t]


@pytest.mark.parametrize("dark", [True, False])
def test_any_every_block_or_no_block_goes_dark(big_clusters, cuda, dark):
    """dark: every ray hits the block's first cluster, so a sequential
    walk needs one visit per block. Otherwise t_cap is just above T_MIN,
    nothing is hit, and every block's items visit its whole list."""
    cl = big_clusters
    o, d, ids, counts = _aimed(cl, cuda, 8, 23)
    tc = cl.tc.to(cuda)
    t_cap = torch.full((o.shape[0],), 1e3 if dark else 2 * ik.T_MIN,
                       device=cuda)
    occ, visits, need = _check_any(o, d, t_cap, ids, counts, tc,
                                   ik._k_cap(cl.n_clusters))
    if dark:
        assert bool(occ.all()) and bool((need == 1).all())
        assert bool((visits >= 1).all())
    else:
        assert not bool(occ.any())
        assert torch.equal(need, counts) and torch.equal(visits, counts)


def test_depth1_gradients_match_finite_differences(cuda):
    """The training path on the card: at depth 1 no sampled direction is
    traced, so d L.mean() / d param of a 4,096-ray strip (through both
    kernels) lies within 2% of a central finite difference of the same
    render, for beta_m, beta_n and each sigma_a channel
    (``chip_smoke.gradient_check``, which fails the run past 2%)."""
    import chip_smoke

    scene_d, cam_d = gen.curly_hairball(n_strands=300, n_seg=8)
    sc, _ = build_scene_clusters(tscene.from_dict(scene_d, device=cuda),
                                 device=cuda)
    cam = tscene.camera_from_dict(cam_d, device=cuda)
    before = dict(ik.LAUNCHES)
    pairs = chip_smoke.gradient_check(sc, cam, cuda, width=64, height=64,
                                      n_rays=4096)
    assert all(ik.LAUNCHES[k] > before[k] for k in CLUSTER_KERNELS)
    assert [p["param"] for p in pairs] == [
        "beta_m", "beta_n", "sigma_a[0]", "sigma_a[1]", "sigma_a[2]"]
    for p in pairs:
        assert abs(p["finite_difference"]) > 1e-4, p
        assert p["rel_err"] <= chip_smoke.FD_RTOL, p


@pytest.fixture(scope="module")
def config5_clusters():
    """Config 5's clusters at full size: 300,000 segments in C = 4,096
    clusters (a power of two), more than MAX_IDS = 2,048 list slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    scene_d, _ = gen.furry_bunny()
    _, cl = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                 device="cpu")
    assert cl.n_clusters > ik.MAX_IDS
    return cl


@pytest.mark.parametrize("kind", ["hit", "any"])
def test_sentinel_past_max_ids(config5_clusters, cuda, kind):
    """C > MAX_IDS: block 0 lists every cluster, more than the k_cap =
    MAX_IDS slots, so it goes as the "scan every cluster" sentinel; the
    other blocks keep their front-to-back lists. Shadow rays to the
    environment carry t_max = 1e30."""
    cl = config5_clusters
    c, k_cap = cl.n_clusters, ik._k_cap(cl.n_clusters)
    assert k_cap == ik.MAX_IDS < c
    rng = np.random.default_rng(24)
    o = rng.normal(size=(512, 3)) * 0.6
    d = rng.normal(size=(512, 3)) * 0.05 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.as_tensor(o, dtype=torch.float32)
    d = torch.as_tensor(d, dtype=torch.float32)
    t_max = torch.full((512,), 1e30)
    ids, counts = ik._block_cluster_lists(o, d, cl, t_max=t_max)
    ids[0] = torch.as_tensor(rng.permutation(c), dtype=torch.int32)
    counts[0] = c
    o, d, t_max, ids, counts = (x.to(cuda) for x in (o, d, t_max, ids,
                                                     counts))
    tc = cl.tc.to(cuda)
    if kind == "hit":
        got = _check_hit(o, d, _no_seeds(512, cuda), ids, counts, tc, k_cap)
        assert (got[0][:128] < ik.INF).sum() > 10
    else:
        got, _, need = _check_any(o, d, t_max, ids, counts, tc, k_cap)
        assert got[:128].sum() > 10 and int(need[0]) > 0


def test_config5_gradients_match_the_cpu(cuda):
    """The small config 5's gradients through both kernels at depth 2 on
    a 16x16 window at the image centre, against the same rays on the CPU
    (plain kernels): within ``chip_smoke.GRAD5_RTOL``, finite and
    non-zero (``chip_smoke.device_gradient_check``, which fails the run
    past it)."""
    import chip_smoke
    from oracle.envmap import gradient_sky

    scene_d, cam_d = gen.furry_bunny(n_strands=200, subdiv=1)
    scene_d = dict(scene_d, env_map=gradient_sky(h=16, w=32))
    sc, _ = build_scene_clusters(tscene.from_dict(scene_d, device=cuda),
                                 device=cuda)
    cam = tscene.camera_from_dict(cam_d, device=cuda)
    before = dict(ik.LAUNCHES)
    pairs = chip_smoke.device_gradient_check(sc, cam, cuda, width=64,
                                             height=64, window=16, depth=2)
    assert all(ik.LAUNCHES[k] > before[k]
               for k in CLUSTER_KERNELS + TRIANGLE_KERNELS)
    assert [p["param"] for p in pairs] == [
        "beta_m", "beta_n", "sigma_a[0]", "sigma_a[1]", "sigma_a[2]"]
    for p in pairs:
        assert p["cpu"] != 0 and p["rel_err"] <= chip_smoke.GRAD5_RTOL, p


def _small_hairball(cuda):
    scene_d, cam_d = gen.curly_hairball(n_strands=300, n_seg=8)
    sc, _ = build_scene_clusters(tscene.from_dict(scene_d, device=cuda),
                                 device=cuda)
    return sc, tscene.camera_from_dict(cam_d, device=cuda)


def test_instanced_strip_matches_plain(cuda):
    """The small hairball posed as chip_smoke's two instances (two
    hair-material rows): every launch of a 4,096-ray strip at depth 3,
    made on rays in an instance's frame, bit-equal to its plain version,
    the searches bit-equal to the brute force and the recompute over the
    canonical segments (``chip_smoke.phase_kernels``, which fails the
    run otherwise)."""
    import chip_smoke
    from yhair_tpu_torch.accel.instanced import build_instanced

    sc, cam = _small_hairball(cuda)
    hair = type(sc.hair)(*(torch.stack([a, a]) for a in sc.hair))
    hair = hair._replace(beta_m=hair.beta_m * torch.tensor([1.0, 1.6],
                                                           device=cuda))
    sc = sc._replace(hair=hair, accel=build_instanced(
        sc.accel, chip_smoke.INST_FRAMES, inst_mat=[0, 1], device=cuda))
    before = dict(ik.LAUNCHES)
    hit, anyk, lists = chip_smoke.phase_kernels(
        sc, cam, cuda, width=64, height=64, depth=3, strip=0,
        phase="kernels_instanced")
    assert all(ik.LAUNCHES[k] > before[k] for k in CLUSTER_KERNELS)
    # both instances are searched at every bounce, each search building
    # two lists
    assert hit["launches"] >= 6 and anyk["launches"] >= 12
    assert lists["launches"] == hit["launches"] + anyk["launches"]
    assert hit["max_abs_err"] == 0.0


def test_soft_edge_gradients_match_the_cpu(cuda):
    """edge_softness 0.2 on the small hairball: d mean(L) / d radius
    scale and / d one segment's p0 of a 64x64 window at depth 2 through
    both kernels, within ``chip_smoke.SOFT_RTOL`` of the same rays on the
    CPU (``chip_smoke.soft_gradient_check``, which fails the run past
    it). A 16x16 window's radius gradient is a sum that nearly cancels,
    which one path that takes another branch on the card moves by 4%."""
    import chip_smoke

    sc, cam = _small_hairball(cuda)
    before = dict(ik.LAUNCHES)
    out = chip_smoke.soft_gradient_check(sc, cam, cuda, width=128,
                                         height=128, window=64, depth=2)
    assert all(ik.LAUNCHES[k] > before[k] for k in CLUSTER_KERNELS)
    for v in out.values():
        assert v["rel_err"] <= chip_smoke.SOFT_RTOL, v


def test_scene_file_renders_as_its_config_through_both_kernels(cuda,
                                                                tmp_path):
    """Config 2 (the hair patch, 8,000 segments) written by ``convert
    genscene`` and rendered by ``render --scene`` on the card equals
    ``render --config 2`` bit for bit, and the render launches both
    kernels."""
    from yhair_tpu_torch.apps import convert
    from yhair_tpu_torch.apps import render as app

    scene = tmp_path / "config2" / "scene.json"
    scene.parent.mkdir()
    convert.main(["genscene", "hair_patch", str(scene)])
    argv = ["--resolution", "64", "--spp", "2", "--bounces", "2",
            "--device", "cuda"]
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    a = app.main(["--scene", str(scene), *argv,
                  "--output", str(tmp_path / "a.pfm")])
    launches = dict(ik.LAUNCHES)
    b = app.main(["--config", "2", *argv,
                  "--output", str(tmp_path / "b.pfm")])
    assert all(launches[k] > 0 for k in CLUSTER_KERNELS), launches
    assert a["image"].mean() > 0
    np.testing.assert_array_equal(a["image"], b["image"])


def test_debug_nans_runs_clean_through_both_kernels(cuda, tmp_path):
    """``render --debug-nans`` and ``invert --debug-nans`` of a small
    hairball file on the card: no op of the forward or the backward makes
    a NaN, and both kernels run."""
    import json

    from yhair_tpu_torch.apps import convert, invert
    from yhair_tpu_torch.apps import render as app
    from yhair_tpu_torch.utils import debug

    scene = tmp_path / "hairball" / "scene.json"
    scene.parent.mkdir()
    convert.main(["genscene", "curly_hairball", str(scene), "--kwargs",
                  json.dumps({"n_strands": 300, "n_seg": 8})])
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    try:
        res = app.main(["--scene", str(scene), "--resolution", "64",
                        "--spp", "1", "--bounces", "3", "--debug-nans",
                        "--output", str(tmp_path / "x.pfm"),
                        "--device", "cuda"])
        rec = invert.main(["--scene", str(scene), "--resolution", "32",
                           "--spp", "1", "--bounces", "3", "--steps", "2",
                           "--debug-nans", "--out",
                           str(tmp_path / "rec.json"), "--device", "cuda"])
    finally:
        debug.disable_debug_nans()
    assert all(ik.LAUNCHES[k] > 0 for k in CLUSTER_KERNELS), ik.LAUNCHES
    assert np.isfinite(res["image"]).all() and res["image"].mean() > 0
    assert np.isfinite(rec["losses"]).all()


def test_bvh_walk_on_the_card_matches_the_cpu(cuda):
    """The skip-pointer walk on the card (compacting every 16 steps)
    against the CPU's (every step): the same hits bit for bit; and a
    render through the BVH against the cluster kernels': bit-equal but
    for at most 0.1% of the values, the paths whose first hit ties in t
    (the walk keeps the first in its order, the kernels the lowest
    original id; one card run read 1.8e-5 mean |diff| from a handful of
    such values at this size)."""
    from yhair_tpu_torch.accel import build_scene_bvh, traverse
    from yhair_tpu_torch.apps import common

    scene_d, cam_d = gen.curly_hairball(n_strands=400, n_seg=8)
    _, bvh = build_scene_bvh(tscene.from_dict(scene_d, device="cpu"),
                             device="cpu")
    rng = np.random.default_rng(0)
    o = rng.normal(size=(2048, 3)) * 2.0
    d = rng.normal(size=(2048, 3)) * 0.2 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.as_tensor(o, dtype=torch.float32)
    d = torch.as_tensor(d, dtype=torch.float32)
    want = traverse.nearest_hit(o, d, bvh)
    got = traverse.nearest_hit(o.to(cuda), d.to(cuda), bvh.to(cuda))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int(want[2].sum()) > 200

    imgs = []
    for accel in ("bvh", "cluster"):
        sc, cam = common.build_device_scene(scene_d, cam_d, accel=accel,
                                            device=cuda)
        imgs.append(common.progressive_render(sc, cam, 64, 64, 1, 3,
                                              log=None, device=cuda))
    diff = np.abs(imgs[0] - imgs[1])
    assert (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------------------------
# lists_kernel: phase 1 of a search


@pytest.fixture(scope="module")
def hairball_strip():
    """Config 3 (the 10k-strand hairball, C = 1,024) on the card, and
    every list build of a 16,384-ray strip at the centre of its 512x512
    frame at depth 3, as (o, d, t_max, exclude_below) in call order.
    -> (clusters, calls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from yhair_tpu_torch.apps import common
    from yhair_tpu_torch.parallel import mesh

    dev = torch.device("cuda")
    sc, cam, *_ = common.load_config(3, device=dev)
    perm, _ = mesh.tile_pixel_permutation(512, 512)
    mid = perm.size // 2
    pid = torch.as_tensor(perm[mid - 8192:mid + 8192], device=dev)
    calls, lists = [], ik._block_cluster_lists

    def record(o, d, cl, t_max=None, exclude_below=None, return_key=False):
        calls.append((o, d, t_max, exclude_below))
        return lists(o, d, cl, t_max, exclude_below, return_key)
    ik._block_cluster_lists = record
    try:
        mesh.trace_pixels(sc, cam, 512, 512, pid, torch.zeros_like(pid),
                          mesh.key_seed(0), 3, device=dev)
    finally:
        ik._block_cluster_lists = lists
    torch.cuda.synchronize()
    assert sc.accel.n_clusters == 1024 and len(calls) == 18
    return sc.accel, calls


def _synthetic_lists(c, n, seed, dev):
    """c random AABBs (every 17th empty, at 4e30, as the cluster build
    leaves a cluster without segments) and n rays aimed near them.
    -> (clusters, o, d)."""
    from yhair_tpu_torch.ops.clusters import Clusters

    rng = np.random.default_rng(seed)
    centre = rng.normal(size=(c, 3)) * 1.5
    half = rng.uniform(0.02, 0.6, size=(c, 3))
    cmin = (centre - half).astype(np.float32)
    cmax = (centre + half).astype(np.float32)
    cmin[16::17] = cmax[16::17] = np.float32(4e30)
    o = rng.normal(size=(n, 3)) * 4.0
    d = rng.normal(size=(n, 3)) * 0.6 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = torch.zeros(0, device=dev)
    cl = Clusters(s0=z, s1=z, tc=z, cmin=torch.as_tensor(cmin, device=dev),
                  cmax=torch.as_tensor(cmax, device=dev), seg_index=z,
                  n_clusters=c, cluster_size=128)
    return (cl, torch.as_tensor(o, dtype=torch.float32, device=dev),
            torch.as_tensor(d, dtype=torch.float32, device=dev))


def _list_inputs(case, request, dev):
    """-> (o, d, clusters, t_max, exclude_below) of one case, after
    checking that the case holds what it is named for."""
    if case in ("camera", "bounce", "t_max", "exclude"):
        cl, calls = request.getfixturevalue("hairball_strip")
        if case == "camera":
            o, d, t_max, ex = calls[0]
        elif case == "bounce":
            # the last bounce's nearest search, pass 1: sorted rays, the
            # lanes that died parked at 1e8
            o, d, t_max, ex = [c for c in calls if c[2] is None][-1]
            assert bool((o.abs() >= 1e7).all(1).any())
        elif case == "t_max":
            # a pass B's bound: 0 where pass A resolved the ray
            o, d, t_max, _ = next(c for c in calls if c[2] is not None
                                  and c[3] is not None
                                  and bool((c[2] == 0).any()))
            ex = None
            assert bool((t_max > ik.T_MIN).any())
        else:
            o, d, t_max, ex = next(c for c in calls if c[3] is not None)
            assert bool((ex > -torch.inf).any())
        return o, d, cl, t_max, ex
    if case == "config5":
        # three blocks aimed at the bunny and one of lanes parked at 1e8
        # looking back along -(1, 1, 1): every box collapses to a point
        # for them, so that block lists every cluster with segments
        # (2,344 of 4,096), past MAX_IDS
        cl = request.getfixturevalue("config5_clusters").to(dev)
        rng = np.random.default_rng(25)
        o = rng.normal(size=(512, 3)) * 0.6
        d = rng.normal(size=(512, 3)) * 0.05 - o
        o[384:] = 1e8
        d[384:] = -1.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (torch.as_tensor(o, dtype=torch.float32, device=dev),
                torch.as_tensor(d, dtype=torch.float32, device=dev), cl,
                torch.full((512,), 1e30, device=dev), None)
    c = {"global": 20000, "c1": 1, "c127": 127, "nan": 300}[case]
    cl, o, d = _synthetic_lists(c, 512, c, dev)
    t_max = None
    if case == "global":
        assert ik._lists_block_bytes(c) > ik.LISTS_SMEM
    if case == "nan":
        # block 0's only live ray has a NaN direction
        d[5, 1] = torch.nan
        t_max = torch.full((512,), 1e30, device=dev)
        t_max[:128] = 0.0
        t_max[5] = 1e30
    return o, d, cl, t_max, None


LIST_CASES = ("camera", "bounce", "t_max", "exclude", "config5", "global",
              "c1", "c127", "nan")


@pytest.mark.parametrize("case", LIST_CASES)
def test_lists_kernel_matches_plain(cuda, request, case):
    """ids, counts and key of one launch equal the plain twin's bit for
    bit: (a) a hairball strip's camera rays; (b) a later bounce's sorted
    rays with dead lanes at 1e8; (c) t_max with lanes at 0; (d)
    exclude_below from _visited_threshold; (e) config 5's 4,096 clusters
    with a list longer than MAX_IDS; (f) C = 20,000, past the shared
    memory, so the sort runs in global scratch; (g) C of 1 and 127; (h) a
    ray with a NaN direction, which lists nothing."""
    o, d, cl, t_max, ex = _list_inputs(case, request, cuda)
    before = ik.LAUNCHES["lists_kernel"]
    got = ik._block_cluster_lists(o, d, cl, t_max=t_max, exclude_below=ex,
                                  return_key=True)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["lists_kernel"] == before + 1
    want = ik._block_cluster_lists_plain(o, d, cl, t_max, ex,
                                         return_key=True)
    for name, a, b in zip(("ids", "counts", "key"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    ids, counts = ik._block_cluster_lists(o, d, cl, t_max=t_max,
                                          exclude_below=ex)
    assert torch.equal(ids, got[0]) and torch.equal(counts, got[1])
    counts = got[1]
    if case == "config5":
        assert int(counts.max()) > ik.MAX_IDS
    elif case == "nan":
        assert int(counts[0]) == 0 and int(counts[1:].sum()) > 0
    elif case != "c1":
        assert int(counts.sum()) > 0 and int(counts.max()) > 1


def test_one_nearest_and_one_any_build_four_lists(hairball_strip, cuda):
    """On the card one nearest_hit and one any_hit over the hairball's
    1,024 clusters launch lists_kernel 4 times (two passes each), and a
    65,536-ray build allocates its outputs alone: no (rays, C) tensor."""
    cl, calls = hairball_strip
    o, d = calls[0][:2]
    before = ik.LAUNCHES["lists_kernel"]
    t, _, hit = ik.nearest_hit(o, d, cl)
    # just past each hit: the hit rays are occluded, the others are not
    occ = ik.any_hit(o, d, torch.where(hit, t * 1.001, 1e30).contiguous(),
                     cl)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["lists_kernel"] == before + 4
    assert int(hit.sum()) > 100 and torch.equal(occ, hit)

    o4, d4 = o.repeat(4, 1), d.repeat(4, 1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = ik._block_cluster_lists(o4, d4, cl, return_key=True)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    made = sum(x.numel() * x.element_size() for x in out)
    assert grown <= made + (1 << 20) < o4.shape[0] * cl.n_clusters


def test_lists_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    cl, o, d = _synthetic_lists(64, 256, 1, cuda)
    t = torch.ones(256, device=cuda)
    bad = [(o[:200], d[:200], cl, None),
           (o.double(), d.double(), cl, None),
           (o, d, cl, t.double()),
           (torch.cat([o, o], 1)[:, ::2], d, cl, None),
           (o, d, cl, t.cpu()),
           (o, d, cl._replace(cmin=cl.cmin.cpu()), None)]
    before = ik.LAUNCHES["lists_kernel"]
    for o_, d_, cl_, t_ in bad:
        with pytest.raises(ValueError):
            ik._block_cluster_lists(o_, d_, cl_, t_max=t_)
    assert ik.LAUNCHES["lists_kernel"] == before


# ---------------------------------------------------------------------------
# tri_hit_kernel and tri_any_kernel: the triangle search


@pytest.mark.parametrize("case", tts.SEARCH_CASES)
def test_triangle_kernels_match_the_twin(cuda, case):
    """search (one tri_hit_kernel launch) and occluded (one tri_any_kernel
    launch) on each case of the CPU contract test (random soups of 1, 800
    and 5,000 triangles, 1 ray and counts that are no multiple of a
    block, no triangles, duplicated and coplanar ties, bounds at t,
    degenerate triangles, lanes at 1e8, dist at INF) equal the plain twin
    ``_search`` run on the card bit for bit: t, idx and occlusion."""
    inp = tts.case_inputs(case)
    o, d, tris, dist = tts.torch_inputs(inp, cuda)
    t_min, t_max, chunk = inp["t_min"], inp["t_max"], inp["chunk"]
    before = dict(kernels.LAUNCHES)
    t, idx = tri.search(o, d, tris, t_min, t_max, chunk)
    occ = tri.occluded(o, d, dist, tris, t_min, chunk)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {k: v + (k in TRIANGLE_KERNELS)
                                for k, v in before.items()}
    want_t, want_i = tri._search(o, d, tris, t_min, t_max, chunk)
    least, _ = tri._search(o, d, tris, t_min, tri.INF, chunk)
    assert torch.equal(t, want_t) and torch.equal(idx, want_i)
    assert torch.equal(occ, least < dist * (1.0 - 1e-4))


def test_triangle_kernels_on_a_config5_strip(cuda):
    """Config 5 (the furry bunny's 800 triangles) on the card: every
    triangle search of the 65,536-ray strip through the centre of its
    1024x1024 frame at depth 2 (the camera rays' and the bounce's nearest
    searches, the point-light and env-map shadow rays) bit-equal to the
    plain twin (``chip_smoke.phase_triangles``, which fails the run
    otherwise); the kernels searched every ray the counters saw."""
    import chip_smoke
    from yhair_tpu_torch.apps import common
    from yhair_tpu_torch.utils import trace

    sc, cam, *_ = common.load_config(5, device=cuda)
    assert sc.n_triangles == 800
    trace.reset()
    trace.enable()
    try:
        hit, anyk = chip_smoke.phase_triangles(
            sc, cam, cuda, 1024, 1024, 2, 1024 * 1024 // chip_smoke.STRIP // 2)
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert hit["launches"] == 2 and anyk["launches"] == 4
    assert counts["tri.rays_kernel"] == counts["tri.rays"] > 0
