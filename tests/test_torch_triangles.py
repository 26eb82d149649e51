"""Port vs reference: triangle meshes.

On an icosphere (and a textured quad) with rays made with numpy from a
seed: the flattened SoA of ``Triangles.from_meshes`` is bit-equal to the
reference's; ``nearest_hit`` gives the reference's winners and hit mask
exactly and its t to rtol 1e-5 (measured 1.3e-6 on 1 hit of 661, equal
on the rest: XLA's and ATen's 3-term sums can round differently);
``occluded`` the same mask; ``shade_info`` normals and uv to atol 1e-5
(measured 1.4e-6 on 2 of 1,938 values). The search runs over chunks of
rays and of triangles: any chunking gives the same winner (the first
triangle of least t).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.geometry import triangles as jtri
from yhair_tpu_torch.geometry import triangles as ttri

torch.set_num_threads(1)

QUAD = {"positions": [[-0.5, -0.3, -0.4], [0.5, -0.3, -0.4],
                      [0.5, 0.5, -0.4], [-0.5, 0.5, -0.4]],
        "triangles": [[0, 1, 2], [0, 2, 3]],
        "texcoords": [[0, 0], [1, 0], [1, 1], [0, 1]]}


@pytest.fixture(scope="module")
def meshes():
    ico = gen.icosphere([0.1, 0.0, -0.1], 0.4, subdiv=2)
    flat = gen.icosphere([0.0, 0.3, 0.2], 0.2, subdiv=1)
    flat.pop("normals")
    return [ico, flat, QUAD]


def _rays(seed, n=1000):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 1.5
    d = rng.normal(size=(n, 3)) * 0.3 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_from_meshes_matches_reference(meshes):
    want = jtri.Triangles.from_meshes(meshes, mat_id0=3)
    got = ttri.Triangles.from_meshes(meshes, mat_id0=3)
    for k in ttri.Triangles._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    assert got.mat_id.dtype == torch.int32
    assert ttri.Triangles.from_meshes([]).n_triangles == 0


@pytest.mark.parametrize("chunk,ray_chunk", [(2048, 8192), (7, 300)])
def test_nearest_hit_matches_reference(meshes, monkeypatch, chunk,
                                       ray_chunk):
    monkeypatch.setattr(ttri, "RAY_CHUNK", ray_chunk)
    tj = jtri.Triangles.from_meshes(meshes)
    tt = ttri.Triangles.from_meshes(meshes)
    o, d = _rays(0)
    with jax.disable_jit():
        t_w, i_w, h_w = (np.asarray(a) for a in jtri.nearest_hit(
            jnp.asarray(o), jnp.asarray(d), tj, chunk=256))
    t_g, i_g, h_g = ttri.nearest_hit(torch.as_tensor(o), torch.as_tensor(d),
                                     tt, chunk=chunk)
    assert h_w.sum() > 300
    np.testing.assert_array_equal(h_g.numpy(), h_w)
    np.testing.assert_array_equal(i_g.numpy()[h_w], i_w[h_w])
    np.testing.assert_allclose(t_g.numpy()[h_w], t_w[h_w], rtol=1e-5)


def test_occluded_matches_reference(meshes):
    tj = jtri.Triangles.from_meshes(meshes)
    tt = ttri.Triangles.from_meshes(meshes)
    o, d = _rays(1)
    dist = np.random.default_rng(2).uniform(0.5, 3.0, o.shape[0]).astype(
        np.float32)
    with jax.disable_jit():
        want = np.asarray(jtri.occluded(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(dist), tj, chunk=256))
    got = ttri.occluded(torch.as_tensor(o), torch.as_tensor(d),
                        torch.as_tensor(dist), tt)
    assert 50 < want.sum() < want.size - 50
    np.testing.assert_array_equal(got.numpy(), want)


def test_shade_info_matches_reference(meshes):
    tj = jtri.Triangles.from_meshes(meshes, mat_id0=2)
    tt = ttri.Triangles.from_meshes(meshes, mat_id0=2)
    o, d = _rays(3)
    _, idx, hit = ttri.nearest_hit(torch.as_tensor(o), torch.as_tensor(d), tt)
    h = hit.numpy()
    o, d, idx = o[h], d[h], idx.numpy()[h]
    with jax.disable_jit():
        want = jtri.shade_info(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(idx), tj)
    got = ttri.shade_info(torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(idx), tt)
    np.testing.assert_array_equal(got.mat_id.numpy(), np.asarray(want.mat_id))
    for k in ("normal", "gnormal", "uv"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-5, err_msg=k)
    # the textured quad's hits carry its texcoords
    on_quad = idx >= tt.n_triangles - 2
    assert on_quad.sum() > 10
    assert (got.uv.numpy()[on_quad] > 0).all()
