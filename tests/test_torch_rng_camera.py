"""Port vs reference: counter-hash uniforms, seed word, camera rays.

The hash is integer arithmetic and the pinhole camera is basic float
arithmetic plus tan of one constant, so both are held bit-equal (the
camera against eager JAX: under jit XLA may contract products into FMAs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.core import camera as jcamera
from yhair_tpu.parallel import mesh as pmesh
from yhair_tpu_torch.core import camera as tcamera
from yhair_tpu_torch.core import rng as trng
from yhair_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 123456789, 2**31 + 11, 2**32 - 1, 2**32 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_word_matches_key_seed(seed):
    assert tmesh.key_seed(seed) == int(pmesh._key_seed(jax.random.key(seed)))


@pytest.mark.parametrize("seed,depth", [(0, 1), (3, 4), (2**31 + 11, 6)])
def test_uniforms_bit_equal(seed, depth):
    rng = np.random.default_rng(seed % 1000)
    pid = rng.integers(0, 1 << 20, 2000).astype(np.int32)
    sid = rng.integers(0, 64, 2000).astype(np.int32)
    want = np.asarray(pmesh._ray_uniforms(
        jax.random.key(seed), jnp.asarray(pid), jnp.asarray(sid), depth,
        jnp.float32))
    got = tmesh.ray_uniforms(tmesh.key_seed(seed), torch.as_tensor(pid),
                             torch.as_tensor(sid), depth).numpy()
    assert got.shape == (2000, trng.n_uniform_dims(depth))
    np.testing.assert_array_equal(got, want)


def test_tile_permutation_matches():
    for w, h in [(64, 32), (48, 40), (30, 20)]:
        for a, b in zip(tmesh.tile_pixel_permutation(w, h),
                        pmesh.tile_pixel_permutation(w, h)):
            np.testing.assert_array_equal(a, b)


def _camera_inputs(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    i = rng.integers(0, 64, n).astype(np.float32)
    j = rng.integers(0, 48, n).astype(np.float32)
    return i, j, rng.random((n, 4)).astype(np.float32)


def test_camera_rays_bit_equal_eager():
    _, cam_d = gen.curly_hairball(n_strands=10, n_seg=4)
    i, j, u = _camera_inputs()
    with jax.disable_jit():
        oj, dj = jcamera.camera_rays(jcamera.Camera.from_dict(cam_d), 64,
                                     48, jnp.asarray(i), jnp.asarray(j),
                                     jnp.asarray(u))
    ot, dt = tcamera.camera_rays(tcamera.Camera.from_dict(cam_d), 64, 48,
                                 torch.as_tensor(i), torch.as_tensor(j),
                                 torch.as_tensor(u))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_thin_lens_camera_close():
    """With an aperture the lens sample goes through cos/sin, whose ATen
    and XLA implementations differ by ulps: 1e-6 absolute on unit-scale
    rays."""
    _, cam_d = gen.curly_hairball(n_strands=10, n_seg=4)
    cam_d = dict(cam_d, aperture=0.1, focus_dist=1.5)
    i, j, u = _camera_inputs(seed=1)
    oj, dj = jcamera.camera_rays(jcamera.Camera.from_dict(cam_d), 64, 48,
                                 jnp.asarray(i), jnp.asarray(j),
                                 jnp.asarray(u))
    ot, dt = tcamera.camera_rays(tcamera.Camera.from_dict(cam_d), 64, 48,
                                 torch.as_tensor(i), torch.as_tensor(j),
                                 torch.as_tensor(u))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
