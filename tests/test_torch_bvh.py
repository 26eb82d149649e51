"""Port vs reference: the LBVH build, the skip-pointer walk, the BVH
backend of the integrator and of the apps (``accel/lbvh.py``,
``accel/traverse.py``, ``accel.build_scene_bvh``,
``build_device_scene(accel="bvh")``).

The build is numpy on both sides with the same float64 arithmetic:
bit-equal. The reference's walk is a ``lax.while_loop``, compiled even
when called eagerly, so XLA contracts its closest approach into FMAs:
hit masks and winners are equal, t within 1e-5 relative (measured
5.8e-6 on 2,048 rays). The depth-3 render through the BVH is held to
``tests/test_bvh.py:69-70``'s gates (q99.9 < 1e-4, mean < 1e-5) against
the reference's BVH-hooked render, whose hook (the compiled walk) runs
under jit and whose shading runs op by op (measured 1.8e-6 and 3.6e-8;
jitted shading would add its own FMAs, ``tests/test_torch_render.py``).
Against the port's own cluster render it is bit-equal: both searches
give the same (t, original id) winners.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.accel import build_scene_bvh as jbuild_scene_bvh
from yhair_tpu.accel import lbvh as jlbvh
from yhair_tpu.accel import traverse as jtraverse
from yhair_tpu.apps import common as rcommon
from yhair_tpu.core import scene as jscene
from yhair_tpu.integrator import path as jpath
from yhair_tpu_torch import convert as tconvert
from yhair_tpu_torch.accel import build_scene_bvh, lbvh, traverse
from yhair_tpu_torch.accel.traverse import DeviceBVH
from yhair_tpu_torch.apps import common
from yhair_tpu_torch.apps import convert
from yhair_tpu_torch.apps import render as app
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.io import image as img_io
from yhair_tpu_torch.ops import build_scene_clusters

torch.set_num_threads(1)

T_RTOL = 1e-5
RES, SPP, DEPTH = 16, 2, 2


def _padding_case():
    """``tests/test_bvh.py:73``: 3 segments -> one leaf of 4 with a pad."""
    p0 = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float64)
    return p0, p0 + [0, 1, 0], np.full(3, 0.05), np.full(3, 0.05)


@pytest.fixture(scope="module")
def hairball400():
    scene_d, _ = gen.curly_hairball(n_strands=400, n_seg=8)
    return scene_d


def _random_rays(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 2.0
    d = rng.normal(size=(n, 3)) * 0.2 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("method", ["median", "morton"])
@pytest.mark.parametrize("leaf_size", [4, 128])
@pytest.mark.parametrize("case", ["hairball400", "padding"])
def test_lbvh_build_bit_equal(hairball400, case, leaf_size, method):
    segs = (hairball400["segments"] if case == "hairball400"
            else _padding_case())
    want = jlbvh.build(*segs, leaf_size=leaf_size, method=method)
    got = lbvh.build(*segs, leaf_size=leaf_size, method=method)
    assert (got.n_leaves, got.leaf_size) == (want.n_leaves, want.leaf_size)
    for name in ("node_min", "node_max", "skip", "p0", "p1", "r0", "r1",
                 "seg_index"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_skip_indices():
    for k in range(1, 17):
        np.testing.assert_array_equal(lbvh._skip_indices(1 << k),
                                      jlbvh._skip_indices(1 << k))
    np.testing.assert_array_equal(lbvh._skip_indices(1000),
                                  jlbvh._skip_indices(1000))
    sk = lbvh._skip_indices(16)
    # 1-based heap of 8 leaves (tests/test_bvh.py:22-27)
    assert sk[1] == 0 and sk[2] == 3 and sk[3] == 0
    assert sk[5] == 3 and sk[7] == 0 and sk[9] == 5 and sk[15] == 0


@pytest.fixture(scope="module")
def walk_setup(hairball400):
    sc = jscene.from_dict(hairball400)
    _, jbvh, _ = jbuild_scene_bvh(sc)
    bvh = DeviceBVH.from_host(lbvh.build(*(np.asarray(x) for x in
                                           sc.segments), leaf_size=4))
    return jbvh, bvh


def _walks(walk_setup, max_iters=None):
    jbvh, bvh = walk_setup
    o, d = _random_rays()
    want = [np.asarray(x) for x in jtraverse.nearest_hit(
        jnp.asarray(o), jnp.asarray(d), jbvh, max_iters=max_iters)]
    got = [x.numpy() for x in traverse.nearest_hit(
        torch.as_tensor(o), torch.as_tensor(d), bvh, max_iters=max_iters)]
    return got, want


def _same_hits(got, want, min_hits):
    t, idx, hit, orig = got
    tj, ij, hj, oj = want
    np.testing.assert_array_equal(hit, hj)
    assert hit.sum() >= min_hits
    np.testing.assert_allclose(t[hit], tj[hit], rtol=T_RTOL)
    np.testing.assert_array_equal(t[~hit], tj[~hit])
    # tied t may resolve differently on at most 0.1% of the hits
    assert (idx[hit] == ij[hit]).mean() >= 0.999
    assert (orig[hit] == oj[hit]).mean() >= 0.999
    np.testing.assert_array_equal(orig[~hit], 0)


def test_nearest_hit_matches_reference(walk_setup):
    _same_hits(*_walks(walk_setup), min_hits=200)


def test_walk_in_card_schedule_is_identical(walk_setup, monkeypatch):
    """The card compacts and tests for live rays every 16 steps: the same
    results as every step, also when max_iters cuts the walk mid-way
    (37 = 16 + 16 + 5 steps)."""
    _, bvh = walk_setup
    o, d = (torch.as_tensor(x) for x in _random_rays())
    for max_iters in (None, 37):
        every = traverse.nearest_hit(o, d, bvh, max_iters=max_iters)
        monkeypatch.setattr(traverse, "CHECK_EVERY_CPU", 16)
        stats = {}
        sixteen = traverse.nearest_hit(o, d, bvh, max_iters=max_iters,
                                       stats=stats)
        monkeypatch.setattr(traverse, "CHECK_EVERY_CPU", 1)
        for a, b in zip(every, sixteen):
            assert torch.equal(a, b)
        assert stats["steps"] % 16 == 0 or stats["steps"] == max_iters
    got, want = _walks(walk_setup, max_iters=37)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])


def test_padding_never_hits():
    host = lbvh.build(*_padding_case(), leaf_size=4)
    assert host.seg_index[3] == -1 and host.n_leaves == 1
    bvh = DeviceBVH.from_host(host)
    o = torch.tensor([[1e7, 1e7, -10.0], [1e8, 1e8, -10.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t, idx, hit, orig = traverse.nearest_hit(o, d, bvh)
    assert not hit.any()
    # a ray through the real segments still hits
    t, idx, hit, orig = traverse.nearest_hit(
        torch.tensor([[1.0, 0.5, -10.0]]), torch.tensor([[0.0, 0.0, 1.0]]),
        bvh)
    assert bool(hit[0]) and int(orig[0]) == 1


def test_build_scene_bvh_matches_reference(hairball400):
    """The scene the reference's build_scene_bvh returns: the ordered
    padded segments and the reordered segment material ids."""
    jsc, jbvh, _ = jbuild_scene_bvh(jscene.from_dict(hairball400))
    sc, bvh = build_scene_bvh(tscene.from_dict(hairball400, device="cpu"),
                              device="cpu")
    assert sc.accel is bvh and isinstance(bvh, DeviceBVH)
    for name in ("p0", "p1", "r0", "r1"):
        np.testing.assert_array_equal(getattr(sc.segments, name).numpy(),
                                      np.asarray(getattr(jsc.segments,
                                                         name)))
    np.testing.assert_array_equal(sc.seg_mat_id.numpy(),
                                  np.asarray(jsc.seg_mat_id))
    np.testing.assert_array_equal(bvh.skip.numpy(), np.asarray(jbvh.skip))


def test_reference_bvh_scene_hands_over(hairball400):
    """The reference's BVH scene, handed over as numpy, equals the port's
    own build field for field."""
    jsc, _, _ = jbuild_scene_bvh(jscene.from_dict(hairball400))
    got = tconvert.scene_from_numpy(tconvert.flat_fields(jsc),
                                    device="cpu")
    assert isinstance(got.accel, DeviceBVH)
    sc, _ = build_scene_bvh(tscene.from_dict(hairball400, device="cpu"),
                            device="cpu")
    want = tconvert.flat_fields(sc)
    have = tconvert.flat_fields(got)
    assert have.keys() == want.keys()
    for name, v in have.items():
        np.testing.assert_array_equal(v, want[name], err_msg=name)


@pytest.fixture(scope="module")
def render_setup():
    scene_d, cam_d = gen.curly_hairball(n_strands=120, n_seg=6)
    rng = np.random.default_rng(1)
    u = rng.random((32, 32, 2, n_uniform_dims(3))).astype(np.float32)
    return scene_d, cam_d, u


def test_bvh_render_matches_reference_and_clusters(render_setup):
    scene_d, cam_d, u = render_setup
    sc, cam = common.build_device_scene(scene_d, cam_d, accel="bvh",
                                        device="cpu")
    assert isinstance(sc.accel, DeviceBVH)
    got = tpath.render(sc, cam, torch.as_tensor(u), max_depth=3,
                       device="cpu").numpy()

    jsc, jbvh, _ = jbuild_scene_bvh(jscene.from_dict(scene_d))
    walk = jax.jit(lambda o, d: jtraverse.nearest_hit(o, d, jbvh)[:3])

    def hook(o, d):
        with jax.disable_jit(False):
            return walk(o, d)
    with jax.disable_jit():
        want = np.asarray(jpath.render(
            jsc, jscene.camera_from_dict(cam_d), jnp.asarray(u),
            max_depth=3, nearest_segments=hook))
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5

    sc_cl, _ = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                    device="cpu")
    np.testing.assert_array_equal(
        got, tpath.render(sc_cl, cam, torch.as_tensor(u), max_depth=3,
                          device="cpu").numpy())


def test_sort_bounds_leave_out_bvh_padding(render_setup):
    """The BVH's padding segments (at 1e8) stay out of the Morton sort's
    box, as the clusters' do."""
    scene_d, cam_d, _ = render_setup
    sc, _ = common.build_device_scene(scene_d, cam_d, accel="bvh",
                                      device="cpu")
    assert bool((sc.accel.seg_index < 0).any())
    lo, inv = tpath._sort_bounds(sc)
    p0 = torch.as_tensor(np.asarray(scene_d["segments"][0], np.float32))
    assert float((1.0 / inv).max()) < 10.0
    assert torch.all(lo >= p0.amin(0) - 1.0)


def _render(tmp_path, *argv, name):
    hdr = tmp_path / f"{name}.pfm"
    res = app.main([*argv, "--output", str(tmp_path / f"{name}.png"),
                    "--hdr", str(hdr), "--device", "cpu"])
    return res, img_io.load_pfm(hdr)


@pytest.fixture(scope="module")
def hairball_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("bvh") / "scene.json"
    convert.main(["genscene", "curly_hairball", str(path), "--kwargs",
                  '{"n_strands": 100, "n_seg": 6}'])
    return str(path)


def test_render_cli_bvh_matches_reference(tmp_path, hairball_file):
    """``render --accel bvh`` against the reference's BVH build through
    its jitted progressive renderer (``tests/test_torch_apps.py``'s jit
    tolerance)."""
    from yhair_tpu.io import scene_json as rscene_json

    res, got = _render(tmp_path, "--scene", hairball_file, "--accel", "bvh",
                       "--resolution", str(RES), "--spp", str(SPP),
                       "--bounces", str(DEPTH), name="bvh")
    assert isinstance(res["scene"].accel, DeviceBVH)
    rsc, rcam, nearest = rcommon.build_device_scene(
        *rscene_json.load(hairball_file), accel="bvh")
    want = np.asarray(rcommon.progressive_render(
        rsc, rcam, nearest, RES, RES, SPP, DEPTH, seed=0,
        log=lambda *a: None))
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and got.mean() > 1e-3
    assert (diff.max(-1) < 1e-4).mean() >= 0.97
    assert diff.mean() < 5e-4


def test_bvh_checkpoint_resumes(tmp_path, hairball_file):
    """A render checkpointed through the BVH at 1 spp and resumed to 2
    equals the uninterrupted 2-spp render bit for bit."""
    argv = ["--scene", hairball_file, "--accel", "bvh", "--resolution",
            str(RES), "--bounces", str(DEPTH), "--seed", "3"]
    ck = str(tmp_path / "render.ckpt.npz")
    _, full = _render(tmp_path, *argv, "--spp", "2", name="full")
    _, half = _render(tmp_path, *argv, "--spp", "1", "--checkpoint", ck,
                      name="half")
    _, resumed = _render(tmp_path, *argv, "--spp", "2", "--checkpoint", ck,
                         name="resumed")
    np.testing.assert_array_equal(resumed, full)
    assert np.abs(half - full).max() > 0
