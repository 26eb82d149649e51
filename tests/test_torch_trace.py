"""The port's spans and counters (``yhair_tpu_torch/utils/trace.py``), on
the CPU at small sizes, through the cluster search on the tiny hairball.

Off, tracing records no range and counts nothing. On, a render and a
train step record the ``yhair.*`` span tree (each span inside the one
that calls it), change no bit of the image, the loss, the gradients or
the params, and count the lanes and live lanes of every search: the
live counts equal the reference's ``trace(return_alive=True)`` totals
on the same rays, and the lanes equal the counted rays (samples x depth
x (1 + shadow rays a bounce)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scenes import generators as gen
from yhair_tpu.core import scene as jscene
from yhair_tpu.integrator import path as jpath
from yhair_tpu_torch import convert
from yhair_tpu_torch.apps import common
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.camera import camera_rays
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.ops import build_scene_clusters
from yhair_tpu_torch.parallel import mesh
from yhair_tpu_torch.utils import trace

torch.set_num_threads(1)

RES, DEPTH = 32, 3
PARAMS = ("beta_m", "beta_n", "sigma_a")
COUNTERS = ("rays.bounce_lanes", "rays.bounce_live", "rays.shadow_lanes",
            "rays.shadow_live", "shade.live", "shade.hair")


@pytest.fixture(scope="module")
def hairball():
    scene_d, cam_d = gen.curly_hairball(n_strands=300, n_seg=8)
    sc = tscene.from_dict(scene_d, device="cpu")
    sc2, _ = build_scene_clusters(sc, device="cpu")
    cam = tscene.camera_from_dict(cam_d, device="cpu")
    return scene_d, cam_d, sc2, cam


@pytest.fixture
def tracing():
    """Tracing on for the test, off and zeroed after it."""
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def _spans(prof):
    """[(name, start ns, end ns)] of the yhair.* ranges a profile
    recorded, in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("yhair."):
            out.append((e.name(), e.start_ns(), e.end_ns()))
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(span, spans, name):
    """Whether span lies within a span called name."""
    return any(n == name and a <= span[1] and span[2] <= b
               for n, a, b in spans if (n, a, b) != span)


def _render(sc2, cam):
    return common.progressive_render(sc2, cam, RES, RES, 2, DEPTH, seed=3,
                                     log=None, device="cpu")


def _step(sc2, cam, scene_d):
    m = scene_d["hair_material"]
    params = convert.params_from_numpy(
        {k: np.float32(np.asarray(m[k], np.float32) * 1.5) for k in PARAMS},
        device="cpu")
    opt = torch.optim.Adam(params.values(), lr=5e-2)
    step = mesh.train_step_fn(RES, RES, 1, max_depth=DEPTH, device="cpu")
    target = torch.as_tensor(np.random.default_rng(1).random(
        (RES, RES, 3)).astype(np.float32) * 0.2)
    loss, grads = step(params, opt, sc2, cam, target, 7)
    return loss, grads, {k: v.detach() for k, v in params.items()}


def _rays(cam, n_pix, spp, seed):
    u = torch.as_tensor(np.random.default_rng(seed).random(
        (n_pix * spp, n_uniform_dims(DEPTH))).astype(np.float32))
    pix = torch.arange(n_pix).repeat_interleave(spp)
    res = int(round(n_pix ** 0.5))
    o, d = camera_rays(cam, res, res, (pix % res).float(),
                       (pix // res).float(), u[:, :4])
    return o, d, u


def test_off_records_and_counts_nothing(hairball):
    _, _, sc2, cam = hairball
    trace.disable()
    trace.reset()
    assert trace.span("yhair.a") is trace.span("yhair.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(sc2, cam)
    assert _spans(prof) == []
    assert all(v == 0 for v in trace.counters().values())
    assert not trace.enabled()


def test_counters_sum_on_the_device_and_reset(tracing):
    trace.add("a", torch.tensor(3))
    trace.add("a", torch.ones(5, dtype=torch.bool).sum())
    trace.add("b", 7)
    trace.add("b", 2)
    assert trace.counters() == {"a": 8, "b": 9}
    trace.reset()
    assert trace.counters() == {}


def test_render_span_tree(hairball, tracing):
    _, _, sc2, cam = hairball
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(sc2, cam)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    # 2 passes of one 1,024-ray strip, DEPTH bounces a strip
    assert names.count("yhair.pass") == 2
    assert names.count("yhair.rays") == 2
    assert names.count("yhair.bounce") == 2 * DEPTH
    assert names.count("yhair.shading") == 2 * DEPTH
    # a nearest search a bounce, a shadow search a light in its shading
    n_sh = sc2.n_lights
    assert names.count("yhair.search") == 2 * DEPTH * (1 + n_sh)
    assert names.count("yhair.lists") >= names.count("yhair.search")
    for s in spans:
        if s[0] == "yhair.shading":
            assert _inside(s, spans, "yhair.bounce")
        if s[0] == "yhair.bounce":
            assert _inside(s, spans, "yhair.pass")
        if s[0] == "yhair.rays":
            assert _inside(s, spans, "yhair.pass")
        if s[0] == "yhair.lists":
            assert _inside(s, spans, "yhair.search")
    shadow = [s for s in spans if s[0] == "yhair.search"
              and _inside(s, spans, "yhair.shading")]
    nearest = [s for s in spans if s[0] == "yhair.search"
               and not _inside(s, spans, "yhair.shading")]
    assert len(shadow) == 2 * DEPTH * n_sh
    assert len(nearest) == 2 * DEPTH
    assert all(_inside(s, spans, "yhair.bounce") for s in nearest)
    assert "yhair.sort" not in names      # 1,024 rays: no sort


def test_sort_span(hairball, tracing):
    _, _, sc2, cam = hairball
    o, d, u = _rays(cam, 256, 2, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tpath.trace(sc2, o, d, u, max_depth=DEPTH, sort_rays=True,
                    device="cpu")
    spans = _spans(prof)
    sorts = [s for s in spans if s[0] == "yhair.sort"]
    assert len(sorts) == DEPTH - 1
    assert all(_inside(s, spans, "yhair.bounce") for s in sorts)
    assert not any(_inside(s, spans, "yhair.shading") for s in sorts)


def test_train_step_span_tree(hairball, tracing, monkeypatch):
    scene_d, _, sc2, cam = hairball
    # 4 strips of 256 rays
    monkeypatch.setattr(mesh, "MAX_RAYS_PER_STRIP", 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(sc2, cam, scene_d)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names.count("yhair.step") == 1
    assert names.count("yhair.backward") == 4
    assert names.count("yhair.adam") == 1
    assert names.count("yhair.rays") == 4
    assert names.count("yhair.bounce") == 4 * DEPTH
    for s in spans:
        if s[0] != "yhair.step":
            assert _inside(s, spans, "yhair.step"), s
    bwd = [s for s in spans if s[0] == "yhair.backward"]
    assert not any(_inside(s, spans, "yhair.bounce") for s in bwd)
    adam = [s for s in spans if s[0] == "yhair.adam"][0]
    assert adam[1] >= max(s[2] for s in bwd)


def test_results_bit_equal_with_tracing_on(hairball):
    scene_d, _, sc2, cam = hairball
    trace.disable()
    img_off = _render(sc2, cam)
    loss_off, grads_off, params_off = _step(sc2, cam, scene_d)
    trace.reset()
    trace.enable()
    try:
        img_on = _render(sc2, cam)
        loss_on, grads_on, params_on = _step(sc2, cam, scene_d)
    finally:
        trace.disable()
        trace.reset()
    np.testing.assert_array_equal(img_on, img_off)
    assert torch.equal(loss_on, loss_off)
    for k in PARAMS:
        assert torch.equal(grads_on[k], grads_off[k]), k
        assert torch.equal(params_on[k], params_off[k]), k


@pytest.mark.parametrize("sampler", ["path", "naive"])
def test_counters_equal_the_reference(hairball, tracing, sampler):
    """The live lanes of every search against the reference's
    return_alive totals, eager, on the same rays (edge_softness 0, so
    the lanes that shade are the alive ones)."""
    scene_d, _, sc2, cam = hairball
    n_pix, spp = 16 * 16, 2
    o, d, u = _rays(cam, n_pix, spp, 9)
    tpath.trace(sc2, o, d, u, max_depth=DEPTH, sampler=sampler,
                device="cpu")
    got = trace.counters()
    with jax.disable_jit():
        _, (a_in, a_sh) = jpath.trace(
            jscene.from_dict(scene_d), jnp.asarray(o.numpy()),
            jnp.asarray(d.numpy()), jnp.asarray(u.numpy()),
            max_depth=DEPTH, chunk=4096, sampler=sampler, return_alive=True)
    n = n_pix * spp
    n_sh = sc2.n_lights if sampler == "path" else 0
    assert got["rays.bounce_live"] == int(np.sum(a_in))
    assert got["rays.shadow_live"] == int(np.sum(a_sh))
    assert got["rays.bounce_lanes"] == n * DEPTH
    assert got["rays.shadow_lanes"] == n * DEPTH * n_sh
    assert 0 < got["rays.bounce_live"] < got["rays.bounce_lanes"]
    # the lanes shaded are the live ones after the hit test, and each
    # casts one shadow ray a light
    assert got["shade.live"] * n_sh == got["rays.shadow_live"]
    assert 0 < got["shade.hair"] <= got["shade.live"]
    assert got["shade.live"] < got["rays.bounce_live"]


def test_lanes_equal_the_counted_rays(hairball, tracing):
    """A whole render's lanes: samples x depth x (1 + shadow rays a
    bounce), dead lanes included; the live ones fewer."""
    _, _, sc2, cam = hairball
    _render(sc2, cam)
    got = trace.counters()
    samples = RES * RES * 2
    assert sorted(got) == sorted(COUNTERS)
    assert (got["rays.bounce_lanes"] + got["rays.shadow_lanes"]
            == samples * DEPTH * (1 + sc2.n_lights))
    assert 0 < got["rays.bounce_live"] <= got["rays.bounce_lanes"]
    assert 0 < got["rays.shadow_live"] <= got["rays.shadow_lanes"]


def test_eyelight_counts_every_lane_once(hairball, tracing):
    _, _, sc2, cam = hairball
    o, d, u = _rays(cam, 64, 1, 2)
    tpath.trace(sc2, o, d, u, max_depth=DEPTH, sampler="eyelight",
                device="cpu")
    assert trace.counters() == {"rays.bounce_lanes": 64,
                                "rays.bounce_live": 64}
