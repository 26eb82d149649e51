"""Port vs jitted reference: render gradients with respect to the hair
parameters.

The gradient of sum(W * image) for a fixed random W at 12x12 and depth 4:
the port through its cluster search (the plain kernels) against
``jax.jit(jax.grad(...))`` of the reference by brute force, on the same
uniforms. XLA contracts FMAs under jit (``tests/test_torch_render.py``),
which moves single paths: rtol 2e-2, measured 1.7e-3 (beta_n). On larger
images at depth 5 the moved paths change the gradient by far more
(measured 9x on the nearly cancelling beta_m at 32x32), so the tight
comparison, against eager JAX, is ``tests/test_torch_grad.py``'s. This
file is apart from that one so the two JAX references can run on
different test workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from scenes import generators as gen
from yhair_tpu.core import scene as jscene
from yhair_tpu.integrator import path as jpath
from yhair_tpu_torch import convert
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.ops import build_scene_clusters

torch.set_num_threads(1)

PARAMS = ("beta_m", "beta_n", "sigma_a")
RES, DEPTH = 12, 4


def test_render_gradients_match_jitted_reference():
    scene_d, cam_d = gen.curly_hairball(n_strands=300, n_seg=8)
    rng = np.random.default_rng(0)
    u = rng.random((RES, RES, 1, n_uniform_dims(DEPTH))).astype(np.float32)
    w = rng.random((RES, RES, 3)).astype(np.float32)
    m = scene_d["hair_material"]
    p0 = {k: np.asarray(m[k], np.float32) for k in PARAMS}

    sc2, _ = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                  device="cpu")
    params = convert.params_from_numpy(p0, device="cpu")
    img = tpath.render(sc2._replace(hair=sc2.hair._replace(**params)),
                       tscene.camera_from_dict(cam_d, device="cpu"),
                       torch.as_tensor(u), max_depth=DEPTH, device="cpu")
    (torch.as_tensor(w) * img).double().sum().backward()

    jsc = jscene.from_dict(scene_d)
    jcam = jscene.camera_from_dict(cam_d)

    def loss(p):
        sc = jsc._replace(hair=jsc.hair._replace(**p))
        img = jpath.render(sc, jcam, jnp.asarray(u), max_depth=DEPTH,
                           chunk=4096)
        return (jnp.asarray(w) * img).sum()
    want = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in p0.items()})
    for k in PARAMS:
        got = params[k].grad.numpy()
        assert np.isfinite(got).all() and np.abs(got).min() > 0.1, k
        np.testing.assert_allclose(got, np.asarray(want[k]), rtol=2e-2,
                                   err_msg=k)
