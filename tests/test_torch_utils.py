"""Port vs reference: checkpoints and the NaN and finite checks.

Render checkpoints are one file format for both packages, so each
package must read what the other wrote. The port's training state holds
the torch optimizer's state and the pixel-batch generator's. The debug
tests follow ``tests/test_debug.py``; ``enable_debug_nans`` must raise
at an op that makes a NaN, and a config-1 render and a training step
must run clean under it (the port's gated branches compute no NaN on
the side not taken).
"""

import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.utils import checkpoint as rckpt
from yhair_tpu_torch import convert
from yhair_tpu_torch.apps import common
from yhair_tpu_torch.parallel import mesh
from yhair_tpu_torch.utils import checkpoint as tckpt
from yhair_tpu_torch.utils import debug

torch.set_num_threads(1)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_render_state_is_one_format(tmp_path, writer):
    accum = np.random.default_rng(0).random((8, 6, 3)) * 3
    path = str(tmp_path / "render.npz")
    save, load = ((rckpt.save_render_state, tckpt.load_render_state)
                  if writer == "reference" else
                  (tckpt.save_render_state, rckpt.load_render_state))
    save(path, accum, 5, 7, meta={"res": 8})
    st = load(path)
    assert st["next_sample"] == 5 and st["seed"] == 7
    assert st["accum"].dtype == np.float64
    np.testing.assert_array_equal(st["accum"], accum)
    assert tckpt.FORMAT_VERSION == rckpt.FORMAT_VERSION


def test_render_state_refuses_other_versions(tmp_path):
    path = str(tmp_path / "render.npz")
    np.savez_compressed(path, version=tckpt.FORMAT_VERSION + 1,
                        accum=np.zeros((2, 2, 3)), next_sample=1, seed=0)
    with pytest.raises(ValueError, match="checkpoint format"):
        tckpt.load_render_state(path)


def _adam_after_steps(params, n):
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    for i in range(n):
        for p in params.values():
            p.grad = torch.full_like(p, 0.1 * (i + 1))
        opt.step()
    return opt


def test_train_state_roundtrip(tmp_path):
    params = convert.params_from_numpy(
        {"beta_m": np.float32(0.4),
         "sigma_a": np.asarray([0.1, 0.2, 0.3], np.float32)}, device="cpu")
    opt = _adam_after_steps(params, 3)
    gen_ = torch.Generator().manual_seed(5)
    torch.randperm(10, generator=gen_)
    path = tmp_path / "train.pt"
    losses = [0.5, 0.25, 1.0 / 3.0]
    tckpt.save_train_state(path, params, opt, step=17, seed=5,
                           generator=gen_, losses=losses)
    want_draw = torch.randperm(100, generator=gen_)

    fresh = convert.params_from_numpy(
        {"beta_m": np.float32(0.9),
         "sigma_a": np.asarray([1.0, 1.0, 1.0], np.float32)}, device="cpu")
    opt2 = torch.optim.Adam(fresh.values(), lr=1e-2)
    gen2 = torch.Generator().manual_seed(0)
    assert tckpt.load_train_state(path, fresh, opt2, gen2) == (17, 5,
                                                               losses)
    for k in params:
        assert torch.equal(fresh[k], params[k]) and fresh[k].requires_grad
    s1, s2 = opt.state_dict(), opt2.state_dict()
    for i in s1["state"]:
        for k, v in s1["state"][i].items():
            assert torch.equal(v, s2["state"][i][k])
    assert torch.equal(torch.randperm(100, generator=gen2), want_draw)
    with pytest.raises(ValueError, match="this run trains"):
        tckpt.load_train_state(path, {"beta_m": fresh["beta_m"]}, opt2)


def test_assert_finite_disabled_is_noop():
    debug.enable_finite_checks(False)
    assert not debug.finite_checks_enabled()
    debug.assert_finite(torch.tensor(float("nan")), "ignored")


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_assert_finite_concrete(bad):
    debug.enable_finite_checks(True)
    try:
        debug.assert_finite({"a": torch.ones(3), "b": [torch.zeros(2)]},
                            "ok")
        with pytest.raises(FloatingPointError, match="bad"):
            debug.assert_finite({"a": torch.ones(3),
                                 "b": [torch.tensor([1.0, bad])]}, "bad")
    finally:
        debug.enable_finite_checks(False)


def _config1(res=16, scene=None):
    sc, cam = common.build_device_scene(*(scene or gen.single_strand()),
                                        accel="cluster", device="cpu")
    target = torch.as_tensor(np.float32(common.progressive_render(
        sc, cam, res, res, 1, 2, seed=0, log=None, device="cpu")))
    return sc, cam, target


def _train_step(sc, cam, target, res=16):
    params = convert.params_from_numpy({"beta_m": np.float32(0.4)},
                                       device="cpu")
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    step = mesh.train_step_fn(res, res, 1, max_depth=2, device="cpu")
    return step(params, opt, sc, cam, target, 1)


def test_train_step_runs_with_checks_on():
    sc, cam, target = _config1()
    debug.enable_finite_checks(True)
    try:
        loss, grads = _train_step(sc, cam, target)
        assert np.isfinite(float(loss)) and float(grads["beta_m"]) != 0.0
        # a NaN gradient is caught before the guard zeroes it
        sc_bad = sc._replace(hair=sc.hair._replace(
            beta_n=torch.tensor(float("nan"))))
        with pytest.raises(FloatingPointError, match="train_step"):
            _train_step(sc_bad, cam, target)
    finally:
        debug.enable_finite_checks(False)


def test_debug_nans_raises_at_the_op():
    debug.enable_debug_nans()
    try:
        x = torch.tensor([0.0, 1.0])
        torch.empty(4)                    # no values: not checked
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x - 0.5)
        # in the backward: sqrt'(0) * 0 is NaN
        y = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(FloatingPointError, match="NaN produced by"), \
                pytest.warns(UserWarning, match="forward call"):
            (torch.sqrt(y) * 0.0).sum().backward()
    finally:
        debug.disable_debug_nans()
    torch.log(torch.tensor([-1.0]))       # off again


@pytest.mark.parametrize("scene", ["config1", "clustered hairball"])
def test_render_and_train_step_run_clean_under_debug_nans(scene):
    """A render and a training step, forward and backward, make no NaN
    anywhere, so --debug-nans runs end to end: config 1 (brute force)
    and a small hairball through the cluster search."""
    sc, cam, target = _config1(scene=None if scene == "config1" else
                               gen.curly_hairball(n_strands=200, n_seg=6))
    assert (sc.accel is None) == (scene == "config1")
    debug.enable_debug_nans()
    try:
        img = common.progressive_render(sc, cam, 16, 16, 2, 2, seed=3,
                                        log=None, device="cpu")
        loss, grads = _train_step(sc, cam, target)
    finally:
        debug.disable_debug_nans()
    assert np.isfinite(img).all() and img.max() > 0
    assert np.isfinite(float(loss)) and float(grads["beta_m"]) != 0.0
