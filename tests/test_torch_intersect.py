"""Port vs reference: cluster build, cluster lists, two-pass searches.

The cluster build and the per-block lists are plain float comparisons
and sorts on the same arrays, so they are bit-equal to the reference.
The two-pass searches run here through the plain versions of the CUDA
kernels (``hit_pass_plain`` / ``any_pass_plain``) and are bit-equal to
the port's brute force: the same per-axis arithmetic and the same
(t, original id) tie-break. Against the reference's Pallas kernel in
interpret mode (jitted, so XLA contracts FMAs) hits agree and t to
rtol 1e-5, the tolerance of ``test_kernel_ray_padding``.
The kernels themselves are held against the plain versions in
``test_torch_kernels_cuda.py``, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.core import scene as jscene
from yhair_tpu.ops import build_scene_clusters as jbuild_scene_clusters
from yhair_tpu.ops import clusters as jclusters
from yhair_tpu.ops import intersect_kernel as jik
from yhair_tpu_torch import convert
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.geometry import segments as tseg
from yhair_tpu_torch.ops import build_scene_clusters
from yhair_tpu_torch.ops import clusters as tclusters
from yhair_tpu_torch.ops import intersect_kernel as ik

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    scene_d, _ = gen.curly_hairball(n_strands=300, n_seg=8)
    jsc2, jcl, jnearest = jbuild_scene_clusters(jscene.from_dict(scene_d),
                                                interpret=True)
    sc2, cl = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                   device="cpu")
    return scene_d, jsc2, jcl, jnearest, sc2, cl


def _rays(seed, n, radius=2.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * radius
    d = rng.normal(size=(n, 3)) * 0.2 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(
        d, dtype=torch.float32)


def _brute(sc2, cl, o, d):
    return tseg.nearest_hit(o, d, sc2.segments, chunk=512, ids=cl.seg_index)


def test_cluster_build_bit_equal(setup):
    scene_d, *_ = setup
    p0, p1, r0, r1 = (np.asarray(a, np.float32) for a in scene_d["segments"])
    want = jclusters.build(p0, p1, r0, r1, use_native=False)
    got = tclusters.build(p0, p1, r0, r1, device="cpu", use_native=False)
    assert got.n_clusters == want.n_clusters
    for name in ("s0", "s1", "tc", "cmin", "cmax", "seg_index"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_converted_clusters_match_own_build(setup):
    _, _, jcl, _, _, cl = setup
    got = convert.clusters_from_numpy(convert.flat_fields(jcl), device="cpu")
    for name in ("s0", "s1", "tc", "cmin", "cmax", "seg_index"):
        assert torch.equal(getattr(got, name), getattr(cl, name)), name


@pytest.mark.parametrize("bounded", [False, True])
def test_block_cluster_lists_equal(setup, bounded):
    _, _, jcl, _, _, cl = setup
    o, d = _rays(0, 512)
    t_max = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 3.0, 512),
                            dtype=torch.float32) if bounded else None
    want = jik._block_cluster_lists(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jcl, ik.BLOCK,
        t_max=None if t_max is None else jnp.asarray(t_max.numpy()),
        return_key=True)
    got = ik._block_cluster_lists(o, d, cl, t_max=t_max, return_key=True)
    for name, g, w in zip(("ids", "counts", "key"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[1].max() > 1


@pytest.mark.parametrize("k_prefix", [64, 4])
def test_two_pass_nearest_matches_bruteforce(setup, monkeypatch, k_prefix):
    """The plain two-pass search equals the brute force bit for bit, on a
    ray count that needs padding. k_prefix 4 < C forces the two passes
    (the small hairball has fewer clusters than the default prefix)."""
    *_, sc2, cl = setup
    monkeypatch.setattr(ik, "K_PREFIX", k_prefix)
    o, d = _rays(2, 1000)
    t_k, idx_k, hit_k = ik.make_nearest_fn(cl, device="cpu")(o, d)
    t_b, idx_b, hit_b = _brute(sc2, cl, o, d)
    assert hit_b.sum() > 150
    assert torch.equal(hit_k, hit_b)
    assert torch.equal(t_k[hit_k], t_b[hit_b])
    assert torch.equal(idx_k[hit_k], idx_b[hit_b])


@pytest.mark.parametrize("k_any_prefix", [16, 2])
def test_any_hit_equals_nearest(setup, monkeypatch, k_any_prefix):
    """Plain any_hit == (nearest t < t_max), with padding, both passes."""
    *_, sc2, cl = setup
    monkeypatch.setattr(ik, "K_ANY_PREFIX", k_any_prefix)
    o, d = _rays(3, 500)
    t_max = torch.as_tensor(np.random.default_rng(4).uniform(0.5, 4.0, 500),
                            dtype=torch.float32)
    occ = ik.make_occluded_fn(cl, device="cpu")(o, d, t_max)
    t, _, hit = _brute(sc2, cl, o, d)
    want = hit & (t < t_max)
    assert want.sum() > 20 and (~want).sum() > 20
    assert torch.equal(occ, want)


def test_sentinel_scans_every_cluster(setup):
    """counts > k_cap is sent as "scan every cluster": a cut list gives
    the same winner and the same occlusion as the whole list."""
    *_, cl = setup
    o, d = _rays(5, 256)
    n = o.shape[0]
    ids, counts = ik._block_cluster_lists(o, d, cl)
    k_full = ik._k_cap(cl.n_clusters)
    assert counts.max() > 4
    seeds = (torch.full((n,), ik.INF), torch.zeros(n, dtype=torch.int32),
             torch.full((n,), ik.NO_ID))
    full = ik.hit_pass(o, d, seeds, ids, counts, cl.tc, k_full)
    cut = ik.hit_pass(o, d, seeds, ids, counts, cl.tc, 4)
    for a, b in zip(full, cut):
        assert torch.equal(a, b)
    t_cap = full[0] * 0.999
    assert torch.equal(ik.any_pass(o, d, t_cap, ids, counts, cl.tc, k_full),
                       ik.any_pass(o, d, t_cap, ids, counts, cl.tc, 4))


def test_cpu_wrappers_run_the_plain_versions(setup):
    """On CPU tensors the wrappers take the plain path: no launch."""
    *_, cl = setup
    o, d = _rays(6, 256)
    before = dict(ik.LAUNCHES)
    ik.make_nearest_fn(cl, device="cpu")(o, d)
    ik.make_occluded_fn(cl, device="cpu")(o, d, torch.full((256,), 2.0))
    assert ik.LAUNCHES == before


def test_matches_reference_pallas_interpret(setup):
    """Against the reference's Pallas kernel (interpret mode, jitted)."""
    _, _, jcl, jnearest, _, cl = setup
    o, d = _rays(7, 100)
    t_j, _, hit_j = jnearest(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    t, _, hit = ik.make_nearest_fn(cl, device="cpu")(o, d)
    hit_j = np.asarray(hit_j)
    np.testing.assert_array_equal(hit.numpy(), hit_j)
    np.testing.assert_allclose(t.numpy()[hit_j], np.asarray(t_j)[hit_j],
                               rtol=1e-5, atol=1e-6)
    t_max = jnp.asarray(np.random.default_rng(8).uniform(0.5, 4.0, 100),
                        jnp.float32)
    occ_j = jik.make_occluded_fn(jcl, interpret=True)(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), t_max)
    occ = ik.make_occluded_fn(cl, device="cpu")(
        o, d, torch.as_tensor(np.asarray(t_max)))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))


# ---------------------------------------------------------------------------
# the kernels' work items: each block's list cut into chunks, each chunk
# searched on its own, merged the way the kernels merge


def _decode_items(prefix, counts, chunk):
    """Every work item as (block, first list position, length), each
    (n_items,) int64, in item order: the kernels' decode of an item."""
    total = int(prefix[-1]) if prefix.numel() else 0
    q = torch.arange(total)
    pre = prefix.long()
    b = torch.searchsorted(pre, q, right=True)
    before = torch.where(b > 0, pre[(b - 1).clamp(min=0)], 0)
    j0 = (q - before) * chunk
    return b, j0, torch.clamp(counts.long()[b] - j0, max=chunk)


def _merge_partials(parts):
    """Fold unseeded (t, idx, oid) results in order by the strict
    lexicographic (t, oid) minimum: on a tie the earlier one stays, as
    the kernel's merge of a block's items does."""
    best_t, best_idx, best_oid = parts[0]
    for t, idx, oid in parts[1:]:
        better = (t < best_t) | ((t == best_t) & (oid < best_oid))
        best_t = torch.where(better, t, best_t)
        best_idx = torch.where(better, idx, best_idx)
        best_oid = torch.where(better, oid, best_oid)
    return best_t, best_idx, best_oid


def _item_lists(ids, counts, k_cap, chunk):
    """(block, cluster ids of the item) for every work item, in item
    order, from packed lists; the sentinel's items run over 0..C-1."""
    prefix = ik._work_items(counts, chunk)
    out = []
    for b, j0, n in zip(*_decode_items(prefix, counts, chunk)):
        b, j0, n = int(b), int(j0), int(n)
        if counts[b] > k_cap:
            item = torch.arange(j0, j0 + n, dtype=torch.int32)
        else:
            item = ids[b, j0:j0 + n]
        out.append((b, item))
    return out


def _hit_pass_items(o, d, seeds, ids, counts, tc, k_cap, chunk=3):
    """hit_pass_plain run item by item: each item unseeded under the seed
    cap, a block's items folded in item order, then the seeds merged."""
    ids, counts = ik._pack_lists(ids, counts, k_cap, tc.shape[0])
    nb = o.shape[0] // ik.BLOCK
    parts = [[] for _ in range(nb)]
    for b, item in _item_lists(ids, counts, k_cap, chunk):
        rows = slice(b * ik.BLOCK, (b + 1) * ik.BLOCK)
        parts[b].append(ik._hit_best_plain(
            o[rows], d[rows], seeds[0][rows], item[None],
            torch.tensor([item.numel()], dtype=torch.int32), tc,
            item.numel()))
    none = (torch.full((ik.BLOCK,), ik.INF),
            torch.zeros(ik.BLOCK, dtype=torch.int32),
            torch.full((ik.BLOCK,), ik.NO_ID))
    best = [_merge_partials(p) if p else none for p in parts]
    best = tuple(torch.cat([x[i] for x in best]) for i in range(3))
    return ik._merge_seeds(best, seeds)


def _any_pass_items(o, d, t_cap, ids, counts, tc, k_cap, chunk=3):
    """any_pass_plain run item by item, the items' flags OR-ed."""
    ids, counts = ik._pack_lists(ids, counts, k_cap, tc.shape[0])
    occ = torch.zeros(o.shape[0], dtype=torch.int32)
    for b, item in _item_lists(ids, counts, k_cap, chunk):
        rows = slice(b * ik.BLOCK, (b + 1) * ik.BLOCK)
        occ[rows] |= ik.any_pass_plain(
            o[rows], d[rows], t_cap[rows], item[None],
            torch.tensor([item.numel()], dtype=torch.int32), tc,
            item.numel())
    return occ


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_work_items_cover_every_list_position_once(chunk):
    """Sentinel (C = 40 > k_cap = 16) and zero-length lists included."""
    k_cap, c = 16, 40
    counts = torch.tensor([0, 5, 30, 0, 16, 1, 17, 9], dtype=torch.int32)
    ids = torch.arange(8 * 40, dtype=torch.int32).reshape(8, 40)
    ids, counts = ik._pack_lists(ids, counts, k_cap, c)
    assert counts.tolist() == [0, 5, c, 0, 16, 1, c, 9]
    prefix = ik._work_items(counts, chunk)
    b, j0, n = _decode_items(prefix, counts, chunk)
    assert int(prefix[-1]) == sum(-(-int(x) // chunk) for x in counts)
    assert bool((n >= 1).all()) and bool((n <= chunk).all())
    seen = sorted((int(bb), int(j)) for bb, jj, nn in zip(b, j0, n)
                  for j in range(int(jj), int(jj + nn)))
    assert seen == [(bb, j) for bb in range(8)
                    for j in range(int(counts[bb]))]
    # items of a block are consecutive and in list order
    assert torch.equal(b, torch.sort(b, stable=True).values)


@pytest.mark.parametrize("k_cap", [None, 4])
@pytest.mark.parametrize("seeded", [False, True])
def test_hit_items_merge_to_the_whole_pass(setup, seeded, k_cap):
    """Item by item and merged as the kernel merges == one plain pass,
    bit for bit; k_cap 4 sends the longer lists as the sentinel."""
    *_, cl = setup
    o, d = _rays(13, 512)
    n = o.shape[0]
    ids, counts = ik._block_cluster_lists(o, d, cl)
    k_cap = k_cap or ik._k_cap(cl.n_clusters)
    seeds = (torch.full((n,), ik.INF), torch.zeros(n, dtype=torch.int32),
             torch.full((n,), ik.NO_ID))
    if seeded:  # a prefix pass's result, as pass 2 gets it
        seeds = ik.hit_pass(o, d, seeds, ids[:, :4],
                            torch.clamp(counts, max=4), cl.tc, 128)
        assert (seeds[0] < ik.INF).sum() > 10
    ids_p, counts_p = ik._pack_lists(ids, counts, k_cap, cl.n_clusters)
    want = ik.hit_pass_plain(o, d, seeds, ids_p, counts_p, cl.tc, k_cap)
    got = _hit_pass_items(o, d, seeds, ids, counts, cl.tc, k_cap)
    assert (want[0] < ik.INF).sum() > 50
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k_cap", [None, 4])
def test_any_items_merge_to_the_whole_pass(setup, k_cap):
    *_, cl = setup
    o, d = _rays(14, 512)
    t_cap = torch.as_tensor(np.random.default_rng(15).uniform(0.5, 4.0, 512),
                            dtype=torch.float32)
    ids, counts = ik._block_cluster_lists(o, d, cl, t_max=t_cap)
    k_cap = k_cap or ik._k_cap(cl.n_clusters)
    ids_p, counts_p = ik._pack_lists(ids, counts, k_cap, cl.n_clusters)
    want = ik.any_pass_plain(o, d, t_cap, ids_p, counts_p, cl.tc, k_cap)
    got = _any_pass_items(o, d, t_cap, ids, counts, cl.tc, k_cap)
    assert want.sum() > 20 and (1 - want).sum() > 20
    assert torch.equal(got, want)


@pytest.mark.parametrize("search", ["nearest", "occluded"])
def test_two_pass_searches_item_by_item(setup, monkeypatch, search):
    """The two-pass searches with every pass run item by item equal the
    plain passes, bit for bit (short prefixes force both passes)."""
    *_, cl = setup
    monkeypatch.setattr(ik, "K_PREFIX", 4)
    monkeypatch.setattr(ik, "K_ANY_PREFIX", 2)
    o, d = _rays(16, 500)
    t_max = torch.as_tensor(np.random.default_rng(17).uniform(0.5, 4.0, 500),
                            dtype=torch.float32)

    def run():
        if search == "nearest":
            return ik.make_nearest_fn(cl, device="cpu")(o, d)
        return (ik.make_occluded_fn(cl, device="cpu")(o, d, t_max),)
    want = run()
    monkeypatch.setattr(ik, "hit_pass", _hit_pass_items)
    monkeypatch.setattr(ik, "any_pass", _any_pass_items)
    got = run()
    assert got[0].any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_any_plain_counts_the_sequential_walk(setup):
    """return_visits: a block's visits end at the one after which all its
    rays are dark, or at its count."""
    *_, cl = setup
    # each block's rays come from one side at the midpoints of one
    # cluster's segments: the block is dark once its walk reaches that
    # cluster, with clusters behind it left in the list
    rng = np.random.default_rng(18)
    seg = np.concatenate([c * 128 + np.arange(128) for c in
                          rng.choice(cl.n_clusters // 2, 8, replace=False)])
    mid = 0.5 * (cl.s0[seg, :3] + cl.s1[seg, :3]).numpy()
    u = np.repeat(rng.normal(size=(8, 3)), 128, axis=0)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    o = torch.as_tensor(mid + 3.0 * u, dtype=torch.float32)
    d = torch.as_tensor(-u, dtype=torch.float32)
    t_cap = torch.full((1024,), 1e3)
    ids, counts = ik._block_cluster_lists(o, d, cl, t_max=t_cap)
    k_cap = ik._k_cap(cl.n_clusters)
    ids, counts = ik._pack_lists(ids, counts, k_cap, cl.n_clusters)
    occ, visits = ik.any_pass_plain(o, d, t_cap, ids, counts, cl.tc, k_cap,
                                    return_visits=True)
    assert torch.equal(occ, ik.any_pass_plain(o, d, t_cap, ids, counts,
                                              cl.tc, k_cap))
    dark_at = ik.any_pass_plain(o, d, t_cap, ids,
                                torch.minimum(counts, visits), cl.tc,
                                k_cap).view(-1, ik.BLOCK).all(1)
    before = ik.any_pass_plain(o, d, t_cap, ids,
                               torch.clamp(visits - 1, min=0), cl.tc,
                               k_cap).view(-1, ik.BLOCK).all(1)
    assert bool((visits <= counts).all()) and not bool(before.any())
    assert bool((dark_at | (visits == counts)).all())
    assert bool((visits < counts).any()), "no block went dark early"
