"""One bounce's hair BSDF in one CUDA launch (``csrc/hair.cu:hair_kernel``,
``bsdf/hair.hair_bounce_kernel``) and its plain twin ``hair_bounce``.

On the CPU: the route (the kernel only for CUDA tensors with autograd
off), the wrapper's refusals and its arguments and layout through
``kernels.launch`` against a fake launch that runs the twin, the
``shade.hair_kernel`` counter and the metric that reads it. The tests
marked ``cuda`` hold the kernel against the twin on the card, bit for
bit. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest tests/test_torch_hair_kernel.py -m cuda
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu_torch import kernels
from yhair_tpu_torch.apps import common
from yhair_tpu_torch.bsdf import hair as th
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.ops import build_scene_clusters
from yhair_tpu_torch.parallel import mesh
from yhair_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
N = 512
# (sigma_a, beta_m, beta_n, alpha) of a per-shape table's rows; the last
# absorbs all but the R lobe and has a narrow azimuthal lobe, so a sample
# drawn at u3 = 0 lands where the pdf is below 1e-12
ROWS = [((0.3, 0.6, 1.2), 0.3, 0.3, 0.0349066),
        ((0.05, 0.1, 0.2), 0.08, 0.6, -0.05),
        ((2.0, 2.5, 3.0), 0.7, 0.15, 0.1),
        ((1e4, 1e4, 1e4), 0.25, 0.05, 0.0)]


def material(kind, device):
    """One material (0-dim leaves) or a table of ROWS, float32."""
    if kind == "one":
        return th.HairMaterial.make([0.3, 0.6, 1.2], device=device)
    sa, bm, bn, al = zip(*ROWS)
    return th.HairMaterial.make(np.array(sa), np.array(bm), np.array(bn),
                                np.array(al), np.full(len(ROWS), 1.55),
                                device=device)


def _unit(rng, n):
    w = rng.normal(size=(n, 3))
    return w / np.linalg.norm(w, axis=-1, keepdims=True)


def lanes(seed, k, edges, mat, device):
    """(mat, mat_id, h, wo, wis, u) of N lanes from numpy; u a 4-column
    view of an (N, 11) tensor, as a bounce's uniforms are. edges: h at
    +-(1 - 1e-3) and at the ends, grazing and zero wo, u1 at and under
    its 1e-5 clamp, u3 = 0 (on the last table row: pdf_h <= 1e-12); u0
    on the lobe-CDF steps is set by ``on_cdf_steps``."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(-1.0, 1.0, N)
    wo, wis = _unit(rng, N), [_unit(rng, N) for _ in range(k)]
    u = rng.uniform(0.0, 1.0, (N, 11))
    mat_id = rng.integers(0, len(ROWS), N)
    if edges:
        q = N // 8
        h[:q] = np.resize([1 - 1e-3, -(1 - 1e-3), 1.0, -1.0, 0.0], q)
        wo[q:2 * q] = np.resize([[1.0, 0.0, 0.0], [-1.0, 1e-7, 0.0],
                                 [0.6, 0.8, 0.0], [0.0, 0.0, 0.0]],
                                (q, 3))
        for w in wis:
            w[2 * q:3 * q] = np.resize([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0],
                                        [0.0, 0.0, 0.0]], (q, 3))
        u[3 * q:4 * q, 1] = np.resize([0.0, 1e-5, 9e-6, 1.0], q)
        u[4 * q:5 * q, 3] = 0.0
        mat_id[4 * q:5 * q] = len(ROWS) - 1
    f32 = np.float32
    t = [torch.as_tensor(x.astype(f32), device=device)
         for x in (h, wo, *wis, u)]
    mat_id = torch.as_tensor(mat_id.astype(np.int32), device=device)
    return (mat, mat_id, t[0], t[1], t[2:2 + k], t[-1][:, 2:6])


def on_cdf_steps(args):
    """args with u0 of lanes 5N/8.. set to the twin's lobe-CDF steps."""
    mat, mat_id, h, wo, wis, u = args
    ctx = th.hair_ctx(th.material_at(mat, mat_id), h, wo)
    steps = torch.stack([ctx.ap_pdf[0], ctx.ap_pdf[0] + ctx.ap_pdf[1],
                         ctx.ap_pdf[0] + ctx.ap_pdf[1] + ctx.ap_pdf[2]], 1)
    q = N // 8
    sel = torch.arange(5 * q, 7 * q, device=h.device)
    u[sel, 0] = steps[sel, sel % 3]
    return args


def same(a, b):
    """Bit-equal float tensors (NaN equal to NaN)."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def assert_bit_equal(got, want):
    for name, a, b in zip(("f", "pdf", "wi_h", "f_h", "pdf_h"), got, want):
        if name in ("f", "pdf"):
            assert len(a) == len(b), name
            for j, (x, y) in enumerate(zip(a, b)):
                assert same(x, y), f"{name}[{j}]"
        else:
            assert same(a, b), name


def twin(args):
    mat, mat_id, h, wo, wis, u = args
    return th.hair_bounce(th.material_at(mat, mat_id), h, wo, wis, u)


# --------------------------------------------------------------------------
# CPU


@pytest.mark.parametrize("grad", [False, True])
def test_route_needs_the_card_and_no_autograd(grad):
    with torch.set_grad_enabled(grad):
        assert tpath._hair_kernel_route(SimpleNamespace(is_cuda=True)) \
            is not grad
        assert not tpath._hair_kernel_route(torch.zeros(3))


class FakeLaunch:
    """Stands for ``kernels.launch`` of ``yhair_hair_shade``: checks the
    arguments against the C entry's order, runs the twin on the table,
    row ids and directions it was given, writes the outputs, counts."""

    def __init__(self):
        self.calls = []

    def __call__(self, entry, *args):
        assert entry == "yhair_hair_shade"
        (h, wo, table, mat_id, wi, k, u, u_ld, n, f, pdf, wi_h, f_h,
         pdf_h) = args
        self.calls.append(args)
        assert (n, k, u_ld) == (h.shape[0], 0 if wi is None else wi.shape[1],
                                u.stride(0))
        cols = [table[:, :3], *table[:, 3:].unbind(1)]
        if mat_id is None:
            assert table.shape[0] == 1
            cols = [c[0] for c in cols]
        mat = th.material_at(th.HairMaterial(*cols), mat_id)
        wis = [] if wi is None else list(wi.unbind(1))
        fs, pdfs, *rest = th.hair_bounce(mat, h, wo, wis, u[:, :4])
        if k:
            f.copy_(torch.stack(fs, 1))
            pdf.copy_(torch.stack(pdfs, 1))
        for out, x in zip((wi_h, f_h, pdf_h), rest):
            out.copy_(x)
        kernels.LAUNCHES["hair_kernel"] += 1


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("kind", ["one", "table"])
def test_wrapper_layout_through_a_fake_launch(monkeypatch, kind, k):
    """The material table, row ids, stacked directions and strided
    uniforms the wrapper passes, and the views it returns, give the
    twin's values bit for bit when the launch runs the twin."""
    fake = FakeLaunch()
    monkeypatch.setattr(kernels, "launch", fake)
    args = on_cdf_steps(lanes(1, k, True, material(kind, "cpu"), "cpu"))
    got = th.hair_bounce_kernel(*args)
    assert len(fake.calls) == 1
    table, mat_id = fake.calls[0][2], fake.calls[0][3]
    assert table.shape == ((1, 7) if kind == "one" else (len(ROWS), 7))
    assert (mat_id is None) == (kind == "one")
    assert_bit_equal(got, twin(args))


def _refusals():
    mat = material("table", "cpu")
    ok = lanes(2, 2, False, mat, "cpu")
    _, mat_id, h, wo, wis, u = ok
    meta = torch.empty(N, device="meta")
    return {
        "h float64": (mat, mat_id, h.double(), wo, wis, u),
        "h on another device": (mat, mat_id, meta, wo, wis, u),
        "wo (N, 2)": (mat, mat_id, h, wo[:, :2], wis, u),
        "wo strided": (mat, mat_id, h, wo.t().contiguous().t(), wis, u),
        "wi short": (mat, mat_id, h, wo, [wis[0][:-1], wis[1]], u),
        "u (N, 3)": (mat, mat_id, h, wo, wis, u[:, :3]),
        "u columns strided": (mat, mat_id, h, wo, wis,
                              torch.zeros(N, 8)[:, ::2]),
        "mat_id int64": (mat, mat_id.long(), h, wo, wis, u),
        "mat_id short": (mat, mat_id[:-1], h, wo, wis, u),
        "material float64": (th.HairMaterial(*(a.double() for a in mat)),
                             mat_id, h, wo, wis, u),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    fake = FakeLaunch()
    monkeypatch.setattr(kernels, "launch", fake)
    args = _refusals()[case]
    with pytest.raises(ValueError):
        th.hair_bounce_kernel(*args)
    assert not fake.calls


def test_twin_leaves_the_first_n_f_pdfs_out():
    mat, mat_id, h, wo, wis, u = lanes(3, 3, False, material("one", "cpu"),
                                       "cpu")
    fs, pdfs, *rest = th.hair_bounce(mat, h, wo, wis, u, n_f=2)
    full = th.hair_bounce(mat, h, wo, wis, u)
    assert pdfs[:2] == [None, None] and same(pdfs[2], full[1][2])
    for a, b in zip(fs + rest, full[0] + list(full[2:])):
        assert same(a, b)


@pytest.fixture(scope="module")
def small_hairball():
    scene_d, cam_d = gen.curly_hairball(n_strands=300, n_seg=8)
    sc, _ = build_scene_clusters(tscene.from_dict(scene_d, device="cpu"),
                                 device="cpu")
    return sc, tscene.camera_from_dict(cam_d, device="cpu")


def test_cpu_takes_the_twin_and_counts_no_kernel_lanes(monkeypatch,
                                                       small_hairball):
    """On the CPU a gradient-free render and a train step's gradients
    both run the twin: the kernel's wrapper is never called, and the
    shade.hair_kernel counter stays at 0 beside shade.hair."""
    def refuse(*args):
        raise AssertionError("hair_bounce_kernel called on the CPU")
    monkeypatch.setattr(th, "hair_bounce_kernel", refuse)
    sc, cam = small_hairball
    trace.reset()
    trace.enable()
    try:
        img = common.progressive_render(sc, cam, 16, 16, 1, 2, seed=3,
                                        log=None, device="cpu")
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert np.isfinite(img).all()
    assert counts["shade.hair"] > 0
    assert counts.get("shade.hair_kernel", 0) == 0
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in (("beta_m", sc.hair.beta_m),
                           ("beta_n", sc.hair.beta_n),
                           ("sigma_a", sc.hair.sigma_a))}
    step = mesh.train_step_fn(16, 16, 1, max_depth=2, device="cpu")
    loss, grads = step(params, torch.optim.Adam(params.values(), lr=1e-3),
                       sc, cam, torch.zeros(16, 16, 3), mesh.key_seed(2))
    assert np.isfinite(float(loss))


def _metric():
    from perfbench.lib import harness
    return harness.Layout(ROOT).metric("hair_kernel_share.render")


@pytest.mark.parametrize("unit,counters,want", [
    ("image", None, None),
    ("image", {}, None),
    ("image", {"shade.live": 90, "shade.hair": 80}, None),
    ("image", {"shade.hair": 0, "shade.hair_kernel": 0}, None),
    ("image", {"shade.hair": 80, "shade.hair_kernel": 80}, 100.0),
    ("image", {"shade.hair": 80, "shade.hair_kernel": 20}, 25.0),
    ("fwdbwd_step", {"shade.hair": 80, "shade.hair_kernel": 80}, None)])
def test_metric_reads_the_counters_or_none(unit, counters, want):
    from perfbench.lib.program import KEY
    cache = {} if counters is None else {KEY: {"counters": counters}}
    run = SimpleNamespace(unit_name=unit, cache=cache)
    assert _metric().read(run) == want


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["one", "table"])
@pytest.mark.parametrize("edges", [False, True])
def test_kernel_matches_the_twin(cuda, edges, kind, k):
    args = lanes(10 + k, k, edges, material(kind, cuda), cuda)
    if edges:
        args = on_cdf_steps(args)
    before = kernels.LAUNCHES["hair_kernel"]
    got = th.hair_bounce_kernel(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hair_kernel"] == before + 1
    want = twin(args)
    assert_bit_equal(got, want)
    if edges and kind == "table":
        assert bool((want[4] <= 1e-12).any())


def _strip_scene(name, dev):
    import chip_smoke
    from oracle.envmap import gradient_sky
    if name == "config 3":
        scene_d, cam_d = gen.curly_hairball(n_strands=300, n_seg=8)
    elif name == "config 5":
        scene_d, cam_d = gen.furry_bunny(n_strands=200, subdiv=1)
        scene_d = dict(scene_d, env_map=gradient_sky(h=16, w=32))
    else:
        return chip_smoke.full_feature_scene(dev)
    sc, _ = build_scene_clusters(tscene.from_dict(scene_d, device=dev),
                                 device=dev)
    return sc, tscene.camera_from_dict(cam_d, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config 3", "config 5", "full feature"])
def test_strips_match_the_twin(cuda, monkeypatch, name):
    """Whole tiny images through ``progressive_render`` (two strips a
    pass, depth 4): one hair_kernel launch a bounce a strip, every hair
    lane on it, and the image bit-equal to the same passes run with the
    twin."""
    sc, cam = _strip_scene(name, cuda)
    width, height, spp, depth = 64, 32, 2, 4
    trace.reset()
    trace.enable()
    before = kernels.LAUNCHES["hair_kernel"]
    try:
        img = common.progressive_render(sc, cam, width, height, spp, depth,
                                        seed=7, log=None, device=cuda,
                                        max_rays_per_call=1024)
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert kernels.LAUNCHES["hair_kernel"] - before == 2 * spp * depth
    assert counts["shade.hair_kernel"] == counts["shade.hair"] > 0
    monkeypatch.setattr(tpath, "_hair_kernel_route", lambda x: False)
    plain = common.progressive_render(sc, cam, width, height, spp, depth,
                                      seed=7, log=None, device=cuda,
                                      max_rays_per_call=1024)
    assert kernels.LAUNCHES["hair_kernel"] - before == 2 * spp * depth
    assert np.array_equal(img, plain)
