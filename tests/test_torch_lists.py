"""The per-block cluster lists (``ops/intersect_kernel._block_cluster_lists``)
on the CPU, against a NumPy brute force.

On the CPU the wrapper runs its plain twin; on a card it launches
``lists_kernel``, which ``test_torch_kernels_cuda.py`` holds bit-equal to
the plain twin. The brute force pins down the contract both are held to:
a per-ray slab test in float32 (the same operations in the same order,
NaN propagating through the min and max), the block minimum of the entry
distances of the rays that hit, the t_max bound and the exclusion, and a
stable argsort of the keys.
"""

import numpy as np
import pytest
import torch

from yhair_tpu_torch.ops import intersect_kernel as ik
from yhair_tpu_torch.ops.clusters import Clusters

F32 = np.float32


def _lists_numpy(o, d, cmin, cmax, t_max=None, exclude=None):
    """-> (ids, counts, key) of the 128-ray blocks, as numpy arrays."""
    with np.errstate(over="ignore", invalid="ignore"):
        return _lists_numpy_inner(o, d, cmin, cmax, t_max, exclude)


def _lists_numpy_inner(o, d, cmin, cmax, t_max, exclude):
    n, c = o.shape[0], cmin.shape[0]
    nb = n // ik.BLOCK
    small = np.where(d < 0, F32(-1e-12), F32(1e-12))
    inv = F32(1.0) / np.where(np.abs(d) < F32(1e-12), small, d)
    block_hit = np.zeros((nb, c), bool)
    tn_block = np.full((nb, c), F32(ik.INF))
    for r in range(n):
        tn = np.full(c, F32(ik.T_MIN))
        tf = np.full(c, F32(ik.INF))
        for ax in range(3):
            t0 = (cmin[:, ax] - o[r, ax]) * inv[r, ax]
            t1 = (cmax[:, ax] - o[r, ax]) * inv[r, ax]
            tn = np.maximum(tn, np.minimum(t0, t1))
            tf = np.minimum(tf, np.maximum(t0, t1))
        hit = tn <= tf
        if t_max is not None:
            hit &= tn <= t_max[r]
        b = r // ik.BLOCK
        block_hit[b] |= hit
        tn_block[b] = np.where(hit, np.minimum(tn_block[b], tn), tn_block[b])
    if exclude is not None:
        block_hit &= ~(tn_block < exclude[:, None])
    key = np.where(block_hit, tn_block, F32(ik.INF))
    ids = np.argsort(key, axis=1, kind="stable").astype(np.int32)
    return ids, block_hit.sum(1).astype(np.int32), key


def _boxes(c, rng):
    """Random AABBs around the origin; every 17th cluster empty, at 4e30,
    as the cluster build leaves a cluster without segments."""
    centre = rng.normal(size=(c, 3)) * 1.5
    half = rng.uniform(0.02, 0.6, size=(c, 3))
    cmin, cmax = (centre - half).astype(F32), (centre + half).astype(F32)
    cmin[16::17] = cmax[16::17] = F32(4e30)
    return cmin, cmax


def _rays(n, rng):
    """Rays from a shell aimed near the origin; some direction components
    0, -0.0 or below 1e-12 (the guarded reciprocal); ray 5 has a NaN
    direction."""
    o = rng.normal(size=(n, 3)) * 4.0
    d = rng.normal(size=(n, 3)) * 0.6 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(F32), d.astype(F32)
    d[1::11, 0] = 0.0
    d[2::13, 1] = -0.0
    d[3::7, 2] = F32(-3e-13)
    d[4::19, 0] = F32(1e-12)
    d[5, 1] = np.nan
    return o, d


def _clusters(cmin, cmax):
    c = cmin.shape[0]
    z = torch.zeros(0)
    return Clusters(s0=z, s1=z, tc=z, cmin=torch.as_tensor(cmin),
                    cmax=torch.as_tensor(cmax), seg_index=z, n_clusters=c,
                    cluster_size=128)


@pytest.mark.parametrize("excluded", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("c", [1, 127, 1000])
def test_lists_match_numpy_brute_force(c, bounded, excluded):
    rng = np.random.default_rng(c * 4 + 2 * bounded + excluded)
    n = 384
    cmin, cmax = _boxes(c, rng)
    o, d = _rays(n, rng)
    t_max = exclude = None
    if bounded:
        # lanes at 0 (resolved or padding) and at 1e30 (to the environment)
        t_max = rng.uniform(0.5, 8.0, n).astype(F32)
        t_max[::9] = 0.0
        t_max[1::10] = F32(1e30)
    if excluded:
        # a prefix pass's thresholds: a visited key, or -inf where the
        # prefix visited nothing
        _, _, key = _lists_numpy(o, d, cmin, cmax, t_max)
        exclude = np.sort(key, axis=1)[:, min(3, c - 1)].copy()
        exclude[1] = -np.inf
    want = _lists_numpy(o, d, cmin, cmax, t_max, exclude)
    cl = _clusters(cmin, cmax)
    args = [torch.as_tensor(x) if x is not None else None
            for x in (o, d, t_max, exclude)]
    got = ik._block_cluster_lists(args[0], args[1], cl, t_max=args[2],
                                  exclude_below=args[3], return_key=True)
    for name, g, w in zip(("ids", "counts", "key"), got, want):
        assert g.dtype == (torch.float32 if name == "key" else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    ids, counts = ik._block_cluster_lists(args[0], args[1], cl,
                                          t_max=args[2],
                                          exclude_below=args[3])
    assert torch.equal(ids, got[0]) and torch.equal(counts, got[1])
    if c > 1:
        assert 0 < int(got[1].sum()) < got[1].numel() * c


def test_nan_ray_lists_nothing():
    """A block whose only live ray has a NaN direction lists nothing."""
    rng = np.random.default_rng(7)
    cmin, cmax = _boxes(64, rng)
    o, d = _rays(128, rng)
    t_max = np.zeros(128, F32)
    t_max[5] = 1e30          # ray 5: the NaN direction
    got = ik._block_cluster_lists(torch.as_tensor(o), torch.as_tensor(d),
                                  _clusters(cmin, cmax),
                                  t_max=torch.as_tensor(t_max),
                                  return_key=True)
    t_max[5], t_max[6] = 0.0, 1e30
    live = ik._block_cluster_lists(torch.as_tensor(o), torch.as_tensor(d),
                                   _clusters(cmin, cmax),
                                   t_max=torch.as_tensor(t_max))
    assert int(got[1][0]) == 0 and bool((got[2] == F32(ik.INF)).all())
    assert torch.equal(got[0][0], torch.arange(64, dtype=torch.int32))
    assert int(live[1][0]) > 0


def _bad_inputs():
    rng = np.random.default_rng(3)
    cmin, cmax = _boxes(40, rng)
    o, d = (torch.as_tensor(x) for x in _rays(256, rng))
    cl = _clusters(cmin, cmax)
    t = torch.ones(256)
    return {
        "ray count": (o[:200], d[:200], cl, None, None),
        "float64 rays": (o.double(), d.double(), cl, None, None),
        "float64 t_max": (o, d, cl, t.double(), None),
        "strided rays": (torch.cat([o, o], 1)[:, ::2], d, cl, None, None),
        "strided t_max": (o, d, cl, torch.ones(512)[::2], None),
        "exclude shape": (o, d, cl, None, torch.zeros(3)),
        "t_max device": (o, d, cl, torch.ones(256, device="meta"), None),
        "boxes device": (o, d, cl._replace(
            cmin=torch.zeros((40, 3), device="meta")), None, None),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_lists_refuse_what_the_kernel_does_not_take(case):
    """The wrapper's checks run before it dispatches, on the CPU too."""
    o, d, cl, t_max, exclude = _bad_inputs()[case]
    with pytest.raises(ValueError):
        ik._block_cluster_lists(o, d, cl, t_max=t_max,
                                exclude_below=exclude)


def test_sort_buffer_sizes():
    """The kernel's sort buffer holds the next power of two >= C pairs;
    a block's bytes pass LISTS_SMEM only past 16,384 clusters."""
    assert [ik._sort_cap(c) for c in (0, 1, 2, 3, 127, 1024, 1025)] == [
        1, 1, 2, 4, 128, 1024, 2048]
    assert ik._lists_block_bytes(4096) == 8 * 4096 + 4 * 4096
    assert ik._lists_block_bytes(16384) <= ik.LISTS_SMEM
    assert ik._lists_block_bytes(16385) > ik.LISTS_SMEM
