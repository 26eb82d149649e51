"""The melanin concentrations as leaves of the port's inverse step.

``bsdf/hair.sigma_a_from_concentration`` against the NumPy oracle (to
float32 rounding), the JAX package's function (bit for bit, eager) and
the benchmark's plain reference; it follows its inputs' device and
carries their gradients. ``parallel/mesh.train_step_fn`` with the
leaves ``eumelanin`` and ``pheomelanin`` on the tiny scalp (config 4's
generator at 300 strands) against ``perfbench/reference/melanin.
train_steps`` on the same inputs, bit for bit over 3 steps, in one strip
a step and in many; their gradients against the sigma_a leaf's by the
chain rule; the leaves that cannot go together; the bounds; the invert
app's least-squares truth. The JAX package is imported only inside the
test that compares with it, so the ``cuda`` test runs on a card without
JAX (``python -m pytest --noconftest tests/test_torch_melanin.py -m
cuda``).
"""

import json

import numpy as np
import pytest
import torch

from oracle import hair_bsdf as ohair
from perfbench.reference import melanin as rmelanin
from perfbench.reference import tracer as rtracer
from scenes import generators as gen
from yhair_tpu_torch.apps import invert
from yhair_tpu_torch.apps.common import build_device_scene
from yhair_tpu_torch.bsdf import hair as th
from yhair_tpu_torch.parallel import mesh

torch.set_num_threads(1)

E = np.array(th.EUMELANIN, np.float32)
P = np.array(th.PHEOMELANIN, np.float32)
LEAVES = ("beta_m", "beta_n", "eumelanin", "pheomelanin")
RES, SPP, DEPTH, BATCH = 32, 2, 2, 256
CE, CP = 1.3, 0.2


@pytest.mark.parametrize("shape", [(), (64,)])
def test_map_equals_the_oracle_jax_and_the_reference(shape):
    import jax.numpy as jnp

    from yhair_tpu.bsdf import hair as jhair
    rng = np.random.default_rng(3)
    ce = rng.uniform(0, 8, shape).astype(np.float32)
    cp = rng.uniform(0, 3, shape).astype(np.float32)
    got = th.sigma_a_from_concentration(torch.as_tensor(ce),
                                        torch.as_tensor(cp)).numpy()
    assert got.shape == shape + (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ohair.sigma_a_from_concentration(ce, cp),
                               rtol=3e-7, atol=0)
    np.testing.assert_array_equal(got, np.asarray(
        jhair.sigma_a_from_concentration(jnp.asarray(ce), jnp.asarray(cp))))
    np.testing.assert_array_equal(got, rmelanin.sigma_a_from_concentration(
        torch.as_tensor(ce), torch.as_tensor(cp)).numpy())
    # floats and arrays become float32 on the CPU, as before
    np.testing.assert_array_equal(
        th.sigma_a_from_concentration(ce.astype(np.float64), cp).numpy(), got)


def test_map_follows_the_inputs_device_and_dtype():
    ce = torch.full((5,), 1.3, device="meta")
    out = th.sigma_a_from_concentration(ce, 0.2)
    assert out.device.type == "meta" and tuple(out.shape) == (5, 3)
    out = th.sigma_a_from_concentration(torch.tensor(1.3, dtype=torch.float64),
                                        torch.tensor(0.2, dtype=torch.float64))
    assert out.dtype == torch.float64


def test_map_carries_the_gradients():
    """d/dce and d/dcp of sigma_a . g are E . g and P . g, row by row."""
    rng = np.random.default_rng(4)
    ce = torch.tensor(rng.uniform(0, 4, 7), dtype=torch.float32,
                      requires_grad=True)
    cp = torch.tensor(rng.uniform(0, 2, 7), dtype=torch.float32,
                      requires_grad=True)
    g = torch.tensor(rng.normal(size=(7, 3)), dtype=torch.float32)
    th.sigma_a_from_concentration(ce, cp).backward(g)
    np.testing.assert_allclose(ce.grad.numpy(), g.numpy() @ E, rtol=1e-6)
    np.testing.assert_allclose(cp.grad.numpy(), g.numpy() @ P, rtol=1e-6)


def _two_materials(scene_d):
    """The scene with a per-shape table of two hair materials: the
    strands of each half of the segments take their own row."""
    n = len(scene_d["segments"][0])
    hm = scene_d["hair_material"]
    rows = [dict(hm), dict(hm, sigma_a=ohair.sigma_a_from_concentration(
        0.4, 0.9), beta_m=0.3)]
    return dict(scene_d, hair_materials=rows, segment_mat_id=np.repeat(
        np.arange(2), [n // 2, n - n // 2]))


@pytest.fixture(scope="module")
def scalp():
    scene_d, cam_d = gen.scalp_model(n_strands=300, n_seg=3,
                                     eumelanin=CE, pheomelanin=CP)
    sc, cam = build_device_scene(scene_d, cam_d, accel="cluster",
                                 device="cpu")
    target = np.random.default_rng(0).random((RES, RES, 3)).astype(
        np.float32) * 0.2
    return scene_d, cam_d, sc, cam, target


def _init(scene_d, scale=1.8):
    truth = dict(scene_d["hair_material"], eumelanin=CE, pheomelanin=CP)
    return {k: (np.asarray(truth[k], np.float64) * scale).astype(np.float32)
            for k in LEAVES}


def _port_steps(sc, cam, target, init, seed, n, lr=0.05):
    params = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    step = mesh.train_step_fn(RES, RES, SPP, max_depth=DEPTH,
                              pixel_batch=BATCH, device="cpu")
    gen_ = torch.Generator().manual_seed(seed)
    out = {"loss": [], "grad1": None, "grads": [], "params": []}
    for it in range(n):
        loss, grads = step(params, opt, sc, cam, torch.as_tensor(target),
                           rtracer.step_seed(seed, it), generator=gen_)
        if it == 0:
            out["grad1"] = {k: opt.state[p]["exp_avg"].detach().clone()
                            / (1.0 - opt.defaults["betas"][0])
                            for k, p in params.items()}
        out["loss"].append(float(loss))
        out["grads"].append(grads)
        out["params"].append({k: v.detach().clone()
                              for k, v in params.items()})
    return out


@pytest.mark.parametrize("strip", [65536, 128])
@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_steps_equal_the_plain_reference(scalp, monkeypatch, seed, strip):
    """Losses, first gradients and parameters after each of 3 steps, bit
    for bit; with 128-ray strips each strip maps the leaves afresh."""
    scene_d, cam_d, sc, cam, target = scalp
    monkeypatch.setattr(mesh, "MAX_RAYS_PER_STRIP", strip)
    monkeypatch.setattr(rtracer, "STRIP_RAYS", strip)
    init = _init(scene_d)
    got = _port_steps(sc, cam, target, init, seed, 3)
    w = {"width": RES, "height": RES, "spp": SPP, "max_depth": DEPTH,
         "pixel_batch": BATCH, "lr": 0.05, "params": list(LEAVES)}
    want = rmelanin.train_steps(scene_d, cam_d, torch.as_tensor(target), w,
                                seed, 3, torch.device("cpu"), torch.float32,
                                init)
    assert got["loss"] == want["loss"]
    for k in LEAVES:
        assert torch.equal(got["grad1"][k], want["grad1"][k]), k
        assert float(got["grad1"][k].abs().sum()) > 0, k
        for a, b in zip(got["params"], want["params"]):
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("rows", [False, True])
def test_chain_rule_through_sigma_a(scalp, rows):
    """On the same pixels and seed, the concentrations' gradients are
    the sigma_a leaf's dotted with the two constant vectors; per-shape
    rows (Mh,) give sigma_a rows (Mh, 3)."""
    scene_d, cam_d, sc, cam, target = scalp
    if rows:
        sc, cam = build_device_scene(_two_materials(scene_d), cam_d,
                                     accel="cluster", device="cpu")
        assert tuple(sc.hair.sigma_a.shape) == (2, 3)
    init = {k: v * 1.5 for k, v in _init(scene_d, 1.0).items()}
    if rows:
        init = {k: np.asarray([v, 0.7 * v], np.float32)
                for k, v in init.items()}
    init = {k: np.asarray(v, np.float32) for k, v in init.items()}
    by_conc = _port_steps(sc, cam, target, init, 5, 1)["grads"][0]
    sa = th.sigma_a_from_concentration(torch.as_tensor(init["eumelanin"]),
                                       torch.as_tensor(init["pheomelanin"]))
    direct = dict({k: init[k] for k in ("beta_m", "beta_n")},
                  sigma_a=sa.numpy())
    by_sa = _port_steps(sc, cam, target, direct, 5, 1)["grads"][0]
    g = by_sa["sigma_a"].numpy()
    assert by_conc["eumelanin"].shape == init["eumelanin"].shape
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(by_conc["eumelanin"].numpy(), g @ E,
                               rtol=1e-5, atol=1e-6 * np.abs(g).max())
    np.testing.assert_allclose(by_conc["pheomelanin"].numpy(), g @ P,
                               rtol=1e-5, atol=1e-6 * np.abs(g).max())
    for k in ("beta_m", "beta_n"):
        np.testing.assert_array_equal(by_conc[k].numpy(), by_sa[k].numpy())


@pytest.mark.parametrize("names", [("beta_m", "eumelanin"),
                                   ("pheomelanin",),
                                   ("eumelanin", "pheomelanin", "sigma_a")])
def test_leaves_that_cannot_go_together(scalp, names):
    _, _, sc, cam, target = scalp
    params = {k: torch.tensor(0.5, requires_grad=True) for k in names}
    step = mesh.train_step_fn(RES, RES, SPP, max_depth=DEPTH,
                              pixel_batch=BATCH, device="cpu")
    with pytest.raises(ValueError):
        step(params, torch.optim.Adam(list(params.values())), sc, cam,
             torch.as_tensor(target), 1, generator=torch.Generator())
    with pytest.raises(ValueError):
        mesh.check_leaves(names)


def test_bounds_hold_the_concentrations(scalp):
    """A step far past the bounds clamps each concentration into its
    own, where the implied sigma_a stays inside sigma_a's."""
    scene_d, _, sc, cam, target = scalp
    init = {k: np.float32(v) for k, v in
            {"beta_m": 0.25, "beta_n": 0.35, "eumelanin": 9.5,
             "pheomelanin": 4.5}.items()}
    out = _port_steps(sc, cam, target, init, 3, 2, lr=1e3)
    for p in out["params"]:
        for k in ("eumelanin", "pheomelanin"):
            lo, hi = mesh.PARAM_BOUNDS[k]
            assert lo <= float(p[k]) <= hi
        sa = th.sigma_a_from_concentration(p["eumelanin"], p["pheomelanin"])
        assert float(sa.max()) <= mesh.PARAM_BOUNDS["sigma_a"][1]
    assert mesh.PARAM_BOUNDS["eumelanin"] == (0.0, 10.0)
    assert mesh.PARAM_BOUNDS["pheomelanin"] == (0.0, 5.0)


def test_invert_app_takes_the_concentrations(tmp_path, capsys):
    """``invert --scene`` on a scene file whose hair material gives the
    concentrations: the least-squares truth recovers them from the
    scene's sigma_a, and the JSON holds them and the sigma_a the
    recovered ones imply."""
    doc = {"camera": {"position": [0.0, 0.35, 1.7],
                      "look_at": [0.0, 0.1, 0.0]},
           "hair_material": {"eumelanin": CE, "pheomelanin": CP,
                             "beta_m": 0.25, "beta_n": 0.35},
           "strands": {"generator": "scalp_model", "n_strands": 100,
                       "n_seg": 3},
           "spheres": [{"center": [0, 0, 0], "radius": 0.3465,
                        "albedo": [0.5, 0.35, 0.28]}],
           "point_lights": [{"position": [2, 3, 2.5],
                             "intensity": [40, 40, 40]}],
           "environment": [0.12, 0.13, 0.15]}
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(doc))
    res = invert.main(["--scene", str(scene), "--resolution", "16",
                       "--spp", "1", "--bounces", "2", "--steps", "2",
                       "--params", ",".join(LEAVES), "--out",
                       str(tmp_path / "rec.json"), "--device", "cpu"])
    assert abs(res["true"]["eumelanin"] - CE) <= 1e-6 * CE
    assert abs(res["true"]["pheomelanin"] - CP) <= 1e-6 * CP
    saved = json.loads((tmp_path / "rec.json").read_text())
    assert set(saved["recovered"]) == set(LEAVES)
    rec = saved["recovered"]
    np.testing.assert_allclose(saved["sigma_a_implied"],
                               th.sigma_a_from_concentration(
                                   rec["eumelanin"], rec["pheomelanin"]))
    assert "no melanin mix" not in capsys.readouterr().out


def test_concentrations_fit_reports_what_is_no_melanin_mix():
    ce, cp, resid = invert.concentrations(
        ohair.sigma_a_from_concentration([1.3, 0.1], [0.2, 0.6]))
    np.testing.assert_allclose(ce, [1.3, 0.1], rtol=1e-12)
    np.testing.assert_allclose(cp, [0.2, 0.6], rtol=1e-12)
    assert resid < 1e-12
    assert invert.concentrations([0.06, 0.10, 0.20])[2] > invert.MELANIN_FIT


@pytest.mark.cuda
def test_concentration_leaves_on_the_card():
    """A CUDA concentration leaf goes through one step of the cluster
    kernels and autograd and gets a finite, nonzero gradient."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    scene_d, cam_d = gen.scalp_model(n_strands=300, n_seg=3)
    sc, cam = build_device_scene(scene_d, cam_d, accel="cluster", device=dev)
    params = {k: torch.tensor(v, device=dev, requires_grad=True)
              for k, v in _init(scene_d).items()}
    step = mesh.train_step_fn(RES, RES, SPP, max_depth=DEPTH,
                              pixel_batch=BATCH, device=dev)
    target = torch.full((RES, RES, 3), 0.05, device=dev)
    loss, grads = step(params, torch.optim.Adam(list(params.values())), sc,
                       cam, target, 9, generator=torch.Generator())
    assert torch.isfinite(loss)
    for k in ("eumelanin", "pheomelanin"):
        assert grads[k].device.type == "cuda"
        assert torch.isfinite(grads[k]).all() and float(grads[k]) != 0.0, k
