"""Port vs reference: closest approach, brute-force nearest hit, shading.

Both packages run on the same arrays (the reference's cluster-ordered
hairball handed over with ``convert``). The closest approach is basic
float arithmetic in the same order, so it is bit-equal to JAX run
eagerly; under ``jit`` XLA on the CPU contracts it into FMAs, so against
jitted JAX hits agree on >= 99.9% of rays and t to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.core import scene as jscene
from yhair_tpu.geometry import segments as jseg
from yhair_tpu.ops import clusters as jclusters
from yhair_tpu_torch import convert
from yhair_tpu_torch.geometry import segments as tseg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hairball():
    scene_d, _ = gen.curly_hairball(n_strands=300, n_seg=8)
    sc = jscene.from_dict(scene_d)
    segs = sc.segments
    cl = jclusters.build(np.asarray(segs.p0), np.asarray(segs.p1),
                         np.asarray(segs.r0), np.asarray(segs.r1),
                         use_native=False)
    jsegs = jseg.Segments(cl.s0[:, :3], cl.s1[:, :3], cl.s0[:, 3],
                          cl.s1[:, 3])
    f = convert.flat_fields(jsegs)
    tsegs = tseg.Segments(*(torch.as_tensor(f[k]) for k in
                            tseg.Segments._fields))
    return jsegs, tsegs, np.asarray(cl.seg_index)


def _rays(seed, n, radius=2.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * radius
    d = rng.normal(size=(n, 3)) * 0.2 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_closest_approach_bit_equal_eager(hairball):
    jsegs, tsegs, _ = hairball
    o, d = _rays(0, 256)
    sel = np.random.default_rng(1).integers(0, 2400, 64)
    with jax.disable_jit():
        want = jseg._closest_approach(
            jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
            jsegs.p0[sel][None], jsegs.p1[sel][None])
    got = tseg._closest_approach(
        torch.as_tensor(o)[:, None], torch.as_tensor(d)[:, None],
        tsegs.p0[sel][None], tsegs.p1[sel][None])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bruteforce_bit_equal_eager(hairball):
    jsegs, tsegs, sidx = hairball
    o, d = _rays(2, 512)
    with jax.disable_jit():
        tj, ij, hj = jseg.nearest_hit(jnp.asarray(o), jnp.asarray(d), jsegs,
                                      chunk=512, ids=jnp.asarray(sidx))
    tt, it, ht = tseg.nearest_hit(torch.as_tensor(o), torch.as_tensor(d),
                                  tsegs, chunk=512,
                                  ids=torch.as_tensor(sidx))
    hj = np.asarray(hj)
    assert hj.sum() > 100
    np.testing.assert_array_equal(ht.numpy(), hj)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(it.numpy()[hj], np.asarray(ij)[hj])


def test_bruteforce_close_to_jit(hairball):
    jsegs, tsegs, sidx = hairball
    o, d = _rays(3, 1024)
    tj, _, hj = jax.jit(lambda a, b: jseg.nearest_hit(
        a, b, jsegs, chunk=512, ids=jnp.asarray(sidx)))(jnp.asarray(o),
                                                        jnp.asarray(d))
    tt, _, ht = tseg.nearest_hit(torch.as_tensor(o), torch.as_tensor(d),
                                 tsegs, chunk=512, ids=torch.as_tensor(sidx))
    hj, ht = np.asarray(hj), ht.numpy()
    assert (hj == ht).mean() >= 0.999
    both = hj & ht
    np.testing.assert_allclose(tt.numpy()[both], np.asarray(tj)[both],
                               rtol=1e-5)


def test_shade_info_close(hairball):
    """Shading frames go through sqrt and normalisation: allclose 1e-5."""
    jsegs, tsegs, sidx = hairball
    o, d = _rays(4, 512)
    tt, it, ht = tseg.nearest_hit(torch.as_tensor(o), torch.as_tensor(d),
                                  tsegs, chunk=512, ids=torch.as_tensor(sidx))
    h = ht.numpy()
    want = jseg.shade_info(jnp.asarray(o[h]), jnp.asarray(d[h]),
                           jnp.asarray(tt.numpy()[h]),
                           jnp.asarray(it.numpy()[h]), jsegs)
    got = tseg.shade_info(torch.as_tensor(o[h]), torch.as_tensor(d[h]),
                          tt[ht], it[ht].long(), tsegs)
    for name in tseg.SegmentShade._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
