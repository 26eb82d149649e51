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
    got = tclusters.build(p0, p1, r0, r1, device="cpu")
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
