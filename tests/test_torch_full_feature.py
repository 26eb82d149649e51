"""Port vs reference: one training step on the all-features scene.

The scene of ``__graft_entry__.py:112-160`` (two posed instances of one
cluster build, a first-class Bezier curve, a textured emissive quad, an
environment map, a textured plane, a point light), which the port builds
without JAX (``chip_smoke.full_feature_scene``). One ``train_step_fn``
step (16x16, 2 spp, depth 2, edge_softness 0.2) against the reference's
single-device step, jitted (its Pallas kernel in interpret mode) on the
same params, target and seed: the loss within rtol 1e-5 (measured
4.6e-7) and each gradient within rtol 1e-3 (measured 1.7e-4, beta_n:
XLA's FMA contraction of the jitted reference, ``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from yhair_tpu.parallel import mesh as jmesh
from yhair_tpu_torch import convert
from yhair_tpu_torch.parallel import mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    # the reference's Pallas re-execution can trip over executables that
    # earlier files in the same process cached (ADVICE.md, test_instances)
    jax.clear_caches()
    yield


def test_full_feature_train_step_matches_reference():
    import __graft_entry__

    res, spp, depth, soft, lr = 16, 2, 2, 0.2, 1e-2
    p0 = {"beta_m": np.float32(0.5), "beta_n": np.float32(0.5),
          "sigma_a": np.full(3, 0.2, np.float32)}
    target = np.random.default_rng(4).random((res, res, 3)).astype(
        np.float32) * 0.3
    sc, cam = chip_smoke.full_feature_scene(torch.device("cpu"))
    assert sc.n_curves == 1 and sc.n_area_lights == 2 and sc.n_planes == 1
    assert sc.accel.n_instances == 2 and sc.env_map.shape[0] == 4
    params = convert.params_from_numpy(p0, device="cpu")
    step = mesh.train_step_fn(res, res, spp, max_depth=depth,
                              edge_softness=soft, device="cpu")
    loss, grads = step(params, torch.optim.Adam(params.values(), lr=lr), sc,
                       cam, torch.as_tensor(target), mesh.key_seed(1))

    jsc, jcam = __graft_entry__._build_full_feature_scene()
    opt = optax.adam(lr)
    jstep = jax.jit(jmesh.train_step_fn(width=res, height=res, spp=spp,
                                        max_depth=depth, optimizer=opt,
                                        edge_softness=soft))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    _, _, jloss, jgrads = jstep(jp, opt.init(jp), jsc, jcam,
                                jnp.asarray(target), jax.random.key(1))
    assert np.isfinite(float(loss)) and float(loss) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k, g in grads.items():
        g = g.numpy()
        assert np.isfinite(g).all() and (g != 0).all(), k
        np.testing.assert_allclose(g, np.asarray(jgrads[k]), rtol=1e-3,
                                   err_msg=k)
