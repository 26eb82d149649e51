"""Port vs reference: the native C++ cluster builder
(``accel/native.py``) and ``clusters.build(use_native=, method=)``.

Both packages compile the same ``native/cluster_builder.cpp`` with the
same flags (the port into its own build directory), so their outputs
are equal. The native builder reads float32; the numpy build reads
whatever it is given, so the two layouts are equal from a scene's
float32 segments and may differ from the generators' float64 arrays,
in both packages. Where the layouts differ the kernels still find the
same hits (``tests/test_native.py:51-81``).

The native tests skip only where ``native.available()`` is False: no
g++ (or no ``native/cluster_builder.cpp``) to build the library with.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.accel import native as rnative
from yhair_tpu.ops import clusters as rclusters
from yhair_tpu.ops import intersect_kernel as rik
from yhair_tpu_torch.accel import native
from yhair_tpu_torch.ops import clusters
from yhair_tpu_torch.ops import intersect_kernel as ik

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("no g++ or no native/cluster_builder.cpp: the native "
                    "cluster builder cannot be built here")
    if not rnative.available():
        pytest.skip("the reference's native/lib was not built (no g++)")


@pytest.fixture(scope="module")
def hairball():
    scene_d, _ = gen.curly_hairball(n_strands=500, n_seg=8)
    return scene_d["segments"]


@pytest.mark.parametrize("method", ["median", "morton"])
def test_build_clusters_matches_reference(built, hairball, method):
    want = rnative.build_clusters(*hairball, cluster_size=128,
                                  method=method)
    got = native.build_clusters(*hairball, cluster_size=128, method=method)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("method", ["median", "morton"])
def test_clusters_build_matches_reference(built, hairball, use_native,
                                          method):
    """Tile for tile, on both routes."""
    want = rclusters.build(*hairball, use_native=use_native, method=method)
    got = clusters.build(*hairball, device="cpu", use_native=use_native,
                         method=method)
    assert got.n_clusters == want.n_clusters
    for name in ("s0", "s1", "tc", "cmin", "cmax", "seg_index"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_layouts_of_float32_segments_are_equal(built):
    """The bench hairball (120,000 segments): from float32 segments, as
    a scene holds them, the native and numpy layouts are bit-equal in
    both packages; from the generator's float64 arrays they differ."""
    scene_d, _ = gen.curly_hairball()
    f64 = scene_d["segments"]
    f32 = [np.asarray(a, np.float32) for a in f64]
    nat = clusters.build(*f32, device="cpu", use_native=True)
    for name in ("s0", "s1", "tc", "cmin", "cmax", "seg_index"):
        a = getattr(nat, name)
        assert torch.equal(a, getattr(clusters.build(
            *f32, device="cpu", use_native=False), name)), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(
            rclusters.build(*f32, use_native=False), name)), err_msg=name)
    assert not torch.equal(nat.seg_index, clusters.build(
        *f64, device="cpu", use_native=False).seg_index)


def test_native_and_numpy_layouts_give_the_same_hits(built):
    """``tests/test_native.py:51-81`` through the port's plain kernels,
    on layouts that differ (the generator's float64 arrays)."""
    scene_d, _ = gen.curly_hairball(n_strands=200, n_seg=6)
    segs = scene_d["segments"]
    cl_nat = clusters.build(*segs, device="cpu", use_native=True)
    cl_np = clusters.build(*segs, device="cpu", use_native=False)
    assert not torch.equal(cl_nat.cmin, cl_np.cmin)
    rng = np.random.default_rng(0)
    o = rng.normal(size=(512, 3)) * 2
    d = rng.normal(size=(512, 3)) * 0.2 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.as_tensor(o, dtype=torch.float32)
    d = torch.as_tensor(d, dtype=torch.float32)
    t_n, i_n, h_n = ik.nearest_hit(o, d, cl_nat)
    t_p, i_p, h_p = ik.nearest_hit(o, d, cl_np)
    assert torch.equal(h_n, h_p) and int(h_n.sum()) > 50
    np.testing.assert_allclose(t_n[h_n].numpy(), t_p[h_p].numpy(),
                               rtol=1e-5, atol=1e-6)
    orig_n = cl_nat.seg_index[i_n.long()][h_n]
    orig_p = cl_np.seg_index[i_p.long()][h_p]
    assert (orig_n == orig_p).float().mean() > 0.999
    # and as the reference's kernel finds them on its native layout; in
    # interpret mode it is jitted, and XLA's FMAs move a grazing hit's t
    # (measured 3.6e-5 relative on 1 of 90 hits)
    rcl = rclusters.build(*segs, use_native=True)
    t_r, i_r, h_r = rik.nearest_hit(jnp.asarray(o.numpy()),
                                    jnp.asarray(d.numpy()), rcl,
                                    interpret=True)
    np.testing.assert_array_equal(h_n.numpy(), np.asarray(h_r))
    np.testing.assert_allclose(t_n[h_n].numpy(),
                               np.asarray(t_r)[h_n.numpy()], rtol=1e-4)
    orig_r = np.asarray(rcl.seg_index)[np.asarray(i_r)][h_n.numpy()]
    assert (orig_n.numpy() == orig_r).mean() > 0.999


def test_unavailable_without_compiler(monkeypatch):
    """With g++ the port builds its own library, in its build directory
    (not native/lib); without g++ the builder is unavailable and the
    build takes the numpy route."""
    if native.available():
        assert native.build().parent == native.BUILD_DIR
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native._lib.cache_clear()
    try:
        assert not native.available()
        assert native.build_clusters(np.zeros((1, 3)), np.ones((1, 3)),
                                     np.ones(1), np.ones(1)) is None
        cl = clusters.build(np.zeros((3, 3)), np.ones((3, 3)), np.ones(3),
                            np.ones(3), device="cpu", use_native=True)
        assert cl.n_clusters == 1
    finally:
        native._lib.cache_clear()
