"""Port vs reference: one inverse-rendering step, and the step's parts.

One ``train_step_fn`` step of the port (cluster search, plain kernels)
against the reference's (brute force, jitted, ``optax.adam``) on the same
scene, target, seed word and params. At depth 1 the jitted reference's
FMA contraction moves no path (``tests/test_torch_render.py``), so the
loss and gradients are held to rtol 1e-4 (measured 2e-6 and 6e-6) and
the new params to rtol 1e-5 (measured 1e-6; Adam's first step is
lr * g / (|g| + eps)). At depth 4 on this 16x16 image the moved paths
change the MSE gradient by up to 7%; ``tests/test_torch_grad.py`` and
``tests/test_torch_grad_jit.py`` hold the deeper render gradients.

The rest is the port alone: strips of 128 rays accumulate the one-batch
gradient (rtol 1e-5: only the f32 summation order differs), the pixel
batch draws whole distinct tiles and its loss is the image's MSE over
them, the bounds clamp, a NaN gradient is zeroed, the CLI writes finite
params.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.core import scene as jscene
from yhair_tpu.parallel import mesh as jmesh
from yhair_tpu_torch import convert
from yhair_tpu_torch.apps import invert
from yhair_tpu_torch.apps import render as app
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.ops import build_scene_clusters
from yhair_tpu_torch.parallel import mesh

torch.set_num_threads(1)

PARAMS = ("beta_m", "beta_n", "sigma_a")
LR = 5e-2


@pytest.fixture(scope="module")
def hairball():
    scene_d, cam_d = gen.curly_hairball(n_strands=300, n_seg=8)
    sc2, _ = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                  device="cpu")
    cam = tscene.camera_from_dict(cam_d, device="cpu")
    return scene_d, cam_d, sc2, cam


def _start(scene_d, scale=1.5):
    m = scene_d["hair_material"]
    return {k: (np.asarray(m[k], np.float32) * scale).astype(np.float32)
            for k in PARAMS}


def _target(res, seed=3):
    return np.random.default_rng(seed).random((res, res, 3)).astype(
        np.float32) * 0.2


def _port_step(sc2, cam, p0, target, res, spp, depth, seed_word=7,
               generator=None, **kw):
    params = convert.params_from_numpy(p0, device="cpu")
    opt = torch.optim.Adam(params.values(), lr=LR)
    step = mesh.train_step_fn(res, res, spp, max_depth=depth, device="cpu",
                              **kw)
    loss, grads = step(params, opt, sc2, cam, torch.as_tensor(target),
                       seed_word, generator=generator)
    return (float(loss), {k: g.numpy() for k, g in grads.items()},
            {k: v.detach().numpy() for k, v in params.items()})


def test_train_step_matches_reference(hairball):
    scene_d, cam_d, sc2, cam = hairball
    # the reference reshapes the tile order into 128-pixel tiles even
    # without a pixel batch, so the image holds whole tiles
    res, spp, depth, seed = 16, 2, 1, 7
    p0, target = _start(scene_d), _target(res)
    loss, grads, new = _port_step(sc2, cam, p0, target, res, spp, depth,
                                  seed_word=mesh.key_seed(seed))

    opt = optax.adam(LR)
    step = jmesh.train_step_fn(width=res, height=res, spp=spp,
                               max_depth=depth, optimizer=opt)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jnew, _, jloss, jgrads = jax.jit(step)(
        jp, opt.init(jp), jscene.from_dict(scene_d),
        jscene.camera_from_dict(cam_d), jnp.asarray(target),
        jax.random.key(seed))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    for k in PARAMS:
        assert np.abs(grads[k]).min() > 1e-4, k
        np.testing.assert_allclose(grads[k], np.asarray(jgrads[k]),
                                   rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(new[k], np.asarray(jnew[k]), rtol=1e-5,
                                   err_msg=k)


def test_strips_accumulate_the_one_batch_gradient(hairball, monkeypatch):
    scene_d, _, sc2, cam = hairball
    res, spp, depth = 16, 2, 3
    p0, target = _start(scene_d), _target(res)
    one = _port_step(sc2, cam, p0, target, res, spp, depth)
    monkeypatch.setattr(mesh, "MAX_RAYS_PER_STRIP", 128)
    assert len(mesh.pixel_strips(res * res, spp)) == 4
    strips = _port_step(sc2, cam, p0, target, res, spp, depth)
    np.testing.assert_allclose(strips[0], one[0], rtol=1e-5)
    for k in PARAMS:
        np.testing.assert_allclose(strips[1][k], one[1][k], rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(strips[2][k], one[2][k], rtol=1e-5,
                                   err_msg=k)


def test_pixel_batch_is_whole_tiles_and_their_mse(hairball):
    scene_d, _, sc2, cam = hairball
    res, spp, depth, k_tiles = 32, 1, 2, 3
    p0, target = _start(scene_d), _target(res)
    loss, _, _ = _port_step(sc2, cam, p0, target, res, spp, depth,
                            pixel_batch=128 * k_tiles,
                            generator=torch.Generator().manual_seed(5))

    tiles = mesh.draw_tiles(res * res // 128, k_tiles,
                            torch.Generator().manual_seed(5)).numpy()
    assert len(set(tiles.tolist())) == k_tiles
    perm, _ = mesh.tile_pixel_permutation(res, res)
    pix = perm.reshape(-1, 128)[tiles]
    for t in pix:   # each tile is one 16x8 block of the screen
        x, y = t % res, t // res
        assert len(set(x // 16)) == 1 and len(set(y // 8)) == 1
        assert len(set(zip(x, y))) == 128

    params = convert.params_from_numpy(p0, device="cpu")
    sc = sc2._replace(hair=sc2.hair._replace(**params))
    img = app.progressive_render(sc, cam, res, res, spp, depth, seed=7,
                                 log=None, device="cpu").reshape(-1, 3)
    want = ((img[pix.reshape(-1)] - target.reshape(-1, 3)[pix.reshape(-1)])
            ** 2).mean()
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    with pytest.raises(ValueError):
        mesh.train_step_fn(res, res, spp, pixel_batch=100, device="cpu")


def test_params_are_clamped_to_their_bounds(hairball):
    scene_d, _, sc2, cam = hairball
    p0 = _start(scene_d)
    p0["beta_m"] = np.float32(1.5)
    p0["sigma_a"] = np.asarray([-0.5, 0.1, 30.0], np.float32)
    _, _, new = _port_step(sc2, cam, p0, _target(8), 8, 1, 2)
    assert new["beta_m"] == mesh.PARAM_BOUNDS["beta_m"][1]
    assert new["sigma_a"][0] == 0.0 and new["sigma_a"][2] == 20.0
    assert 0.0 < new["sigma_a"][1] < 20.0


@pytest.mark.parametrize("name", PARAMS)
def test_nan_gradient_is_zeroed(hairball, name):
    scene_d, _, sc2, cam = hairball
    p0 = _start(scene_d)
    params = convert.params_from_numpy(p0, device="cpu")
    seen = []

    def poison(g):   # the gradient autograd accumulates, made NaN
        seen.append(g.clone())
        return g * float("nan")
    params[name].register_hook(poison)
    opt = torch.optim.Adam(params.values(), lr=LR)
    step = mesh.train_step_fn(8, 8, 1, max_depth=2, device="cpu")
    _, grads = step(params, opt, sc2, cam, torch.as_tensor(_target(8)), 7)
    assert len(seen) == 1 and bool((seen[0] != 0).all())
    for k in PARAMS:
        g = grads[k].numpy()
        if k == name:
            # Adam's first step with a zero gradient leaves the param
            assert (g == 0.0).all()
            np.testing.assert_array_equal(params[k].detach().numpy(), p0[k])
        else:
            assert np.isfinite(g).all() and (g != 0.0).all(), k


def test_invert_cli_writes_finite_params(tmp_path):
    out = tmp_path / "recovered.json"
    res = invert.main(["--config", "1", "--resolution", "16", "--spp", "1",
                       "--bounces", "2", "--steps", "2", "--pixel-batch",
                       "128", "--out", str(out), "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == res
    assert np.isfinite(res["final_loss"])
    for k in PARAMS:
        got = np.asarray(res["recovered"][k])
        start = np.asarray(res["true"][k]) * 1.8
        lo, hi = mesh.PARAM_BOUNDS[k]
        assert np.isfinite(got).all() and (got >= lo).all() and (
            got <= hi).all()
        assert (got != start).all(), k
        assert np.isfinite(res["final_grads"][k]).all()
