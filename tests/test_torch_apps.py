"""Port vs reference: the apps (render, invert, convert, view) and the
progressive renderer's passes and checkpoints, on the CPU at small sizes.

A scene written to a file renders and inverts as the config it came
from, bit for bit. Renders are held against the reference's jitted
progressive renderer to ``tests/test_torch_render.py``'s jit tolerance
(>= 97% of the pixels within 1e-4, mean |diff| < 5e-4): XLA contracts
the reference's arithmetic into FMAs, so paths that sit on a threshold
can part. A resumed render or inverse equals an uninterrupted one bit
for bit. The converter writes the reference's bytes.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from scenes import generators as gen
from yhair_tpu.apps import common as rcommon
from yhair_tpu.apps import convert as rconvert
from yhair_tpu.apps import view as rview
from yhair_tpu.core import scene as jscene
from yhair_tpu.io import hairfile as rhair
from yhair_tpu.io import obj as robj
from yhair_tpu.io import scene_json as rscene_json
from yhair_tpu_torch.apps import common
from yhair_tpu_torch.apps import convert
from yhair_tpu_torch.apps import invert
from yhair_tpu_torch.apps import render as app
from yhair_tpu_torch.apps import view
from yhair_tpu_torch.io import image as img_io
from yhair_tpu_torch.accel.traverse import DeviceBVH
from yhair_tpu_torch.ops.clusters import Clusters

torch.set_num_threads(1)

RES, SPP, DEPTH = 16, 2, 2


def _quiet(*a, **k):
    pass


def _close(got, want):
    """``tests/test_torch_render.py``'s tolerance against jitted JAX."""
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and got.mean() > 1e-3
    assert (diff.max(-1) < 1e-4).mean() >= 0.97
    assert diff.mean() < 5e-4


def _genscene(tmp_path, generator, **kwargs):
    path = tmp_path / generator / "scene.json"
    path.parent.mkdir()
    convert.main(["genscene", generator, str(path),
                  "--kwargs", json.dumps(kwargs)])
    return str(path)


def _render(tmp_path, *argv, name="x"):
    out, hdr = tmp_path / f"{name}.png", tmp_path / f"{name}.pfm"
    app.main([*argv, "--output", str(out), "--hdr", str(hdr),
              "--device", "cpu"])
    return out, img_io.load_pfm(hdr)


def test_scene_file_renders_as_its_config(tmp_path):
    """--scene of config 1 written by genscene equals --config 1 bit for
    bit; the PNG holds the tonemapped image."""
    scene = _genscene(tmp_path, "single_strand")
    argv = ["--resolution", "24", "--spp", "2", "--bounces", "2"]
    png, a = _render(tmp_path, "--scene", scene, *argv, name="scene")
    _, b = _render(tmp_path, "--config", "1", *argv, name="config")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (24, 24, 3) and a.max() > 0
    ldr = img_io.to_ldr(a.astype(np.float32))
    np.testing.assert_array_equal(img_io.load_png(png, to_linear=False),
                                  ldr / 255.0)
    np.testing.assert_array_equal(np.asarray(Image.open(png)), ldr)


@pytest.mark.parametrize("suffix", [".exr", ".hdr", ".npy", ".png"])
def test_render_outputs(tmp_path, suffix):
    out = tmp_path / f"x{suffix}"
    app.main(["--config", "1", "--resolution", "16", "--spp", "1",
              "--bounces", "1", "--output", str(out), "--exposure", "1",
              "--filmic", "--device", "cpu"])
    if suffix == ".png":
        img = img_io.load_png(out)
    else:
        img = img_io.load_hdr(str(out))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("accel", ["cluster", "brute"])
def test_scene_file_render_matches_reference(tmp_path, accel):
    """Config 2 (the hair patch) from a scene file, through each
    backend, against the reference's build_device_scene render."""
    scene = _genscene(tmp_path, "hair_patch")
    _, got = _render(tmp_path, "--scene", scene, "--accel", accel,
                     "--resolution", str(RES), "--spp", str(SPP),
                     "--bounces", str(DEPTH))
    sc, cam, nearest = rcommon.build_device_scene(
        *rscene_json.load(scene), accel=accel)
    want = np.asarray(rcommon.progressive_render(
        sc, cam, nearest, RES, RES, SPP, DEPTH, seed=0, log=_quiet))
    _close(got, want)


@pytest.fixture(scope="module")
def hairball():
    return gen.curly_hairball(n_strands=300, n_seg=8)


def test_spp_per_pass_matches_reference(hairball):
    sc, cam = common.build_device_scene(*hairball, accel="cluster",
                                        device="cpu")
    assert isinstance(sc.accel, Clusters)
    got = common.progressive_render(sc, cam, RES, RES, 4, DEPTH, seed=1,
                                    spp_per_pass=2, log=None, device="cpu")
    one = common.progressive_render(sc, cam, RES, RES, 4, DEPTH, seed=1,
                                    log=None, device="cpu")
    np.testing.assert_allclose(got, one, rtol=1e-12, atol=1e-15)
    rsc, rcam, nearest = rcommon.build_device_scene(*hairball,
                                                    accel="cluster")
    want = np.asarray(rcommon.progressive_render(
        rsc, rcam, nearest, RES, RES, 4, DEPTH, seed=1, spp_per_pass=2,
        log=_quiet))
    _close(got, want)


@pytest.mark.parametrize("spp_per_pass", [1, 2])
def test_resumed_render_is_bit_exact(tmp_path, spp_per_pass):
    argv = ["--config", "1", "--resolution", str(RES), "--bounces",
            str(DEPTH), "--seed", "3", "--spp-per-pass", str(spp_per_pass)]
    ck = str(tmp_path / "render.ckpt.npz")
    _, full = _render(tmp_path, *argv, "--spp", "4", name="full")
    _, half = _render(tmp_path, *argv, "--spp", "2", "--checkpoint", ck,
                      name="half")
    _, resumed = _render(tmp_path, *argv, "--spp", "4", "--checkpoint", ck,
                         name="resumed")
    np.testing.assert_array_equal(resumed, full)
    assert np.abs(half - full).max() > 0
    with pytest.raises(ValueError, match="seed"):
        _render(tmp_path, *argv[:-4], "--seed", "4", "--spp", "6",
                "--checkpoint", ck)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, hairball, first):
    """2 samples rendered and checkpointed by one package, 2 more by the
    other: the whole matches either package's uninterrupted render."""
    ck = str(tmp_path / "render.ckpt.npz")
    sc, cam = common.build_device_scene(*hairball, accel="cluster",
                                        device="cpu")
    rsc, rcam, nearest = rcommon.build_device_scene(*hairball,
                                                    accel="cluster")

    def port(spp, checkpoint=ck):
        return common.progressive_render(sc, cam, RES, RES, spp, DEPTH,
                                         seed=2, checkpoint=checkpoint,
                                         log=None, device="cpu")

    def ref(spp, checkpoint=ck):
        return np.asarray(rcommon.progressive_render(
            rsc, rcam, nearest, RES, RES, spp, DEPTH, seed=2,
            checkpoint=checkpoint, log=_quiet))
    order = (ref, port) if first == "reference" else (port, ref)
    order[0](2)
    got = order[1](4)
    _close(got, ref(4, None))
    _close(got, port(4, None))


INVERT = ["--resolution", "16", "--bounces", "2", "--pixel-batch", "128",
          "--lr", "2e-2"]


def _invert(tmp_path, *argv, name="rec", spp="1"):
    return invert.main([*INVERT, "--spp", spp, *argv, "--out",
                        str(tmp_path / f"{name}.json"), "--device", "cpu"])


@pytest.mark.parametrize("spp,saved_by", [("1", "current"),
                                          ("2", "current"),
                                          ("2", "without_losses")])
def test_invert_resume_is_bit_exact(tmp_path, spp, saved_by):
    """22 steps in one run against 20 steps, a checkpoint, and the 2
    steps left in a second run, at 1 and 2 spp on pixel batches (the
    spec inverse's shape): the same params, losses and gradients, bit
    for bit (the pixel batches come from the restored generator, the
    earlier losses from the checkpoint). A checkpoint saved without its
    losses (as before they were kept) still resumes: the losses then
    start at the resumed step."""
    ck = str(tmp_path / "invert.ckpt")
    whole = _invert(tmp_path, "--config", "1", "--steps", "22", spp=spp)
    _invert(tmp_path, "--config", "1", "--steps", "20", "--checkpoint", ck,
            spp=spp)
    if saved_by == "without_losses":
        st = torch.load(ck, weights_only=True)
        del st["losses"]
        torch.save(st, ck)
    resumed = _invert(tmp_path, "--config", "1", "--steps", "22",
                      "--checkpoint", ck, spp=spp)
    assert len(whole["losses"]) == 22
    if saved_by == "without_losses":
        assert resumed.pop("losses") == whole.pop("losses")[20:]
    assert resumed == whole
    assert whole["recovered"] != resumed["true"]


def test_invert_scene_file_equals_config(tmp_path):
    scene = _genscene(tmp_path, "single_strand")
    a = _invert(tmp_path, "--scene", scene, "--steps", "3", name="a")
    b = _invert(tmp_path, "--config", "1", "--steps", "3", name="b")
    assert a == b and np.isfinite(a["final_loss"])


def test_invert_writes_tensorboard_and_profile(tmp_path):
    tb, prof = tmp_path / "tb", tmp_path / "prof"
    res = _invert(tmp_path, "--config", "1", "--steps", "5", "--tb-logdir",
                  str(tb), "--profile-dir", str(prof))
    assert np.isfinite(res["final_loss"])
    assert glob.glob(str(tb / "events.out.tfevents.*"))
    with open(prof / "invert_trace.json") as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])


def test_invert_profile_has_spans_and_counters(tmp_path):
    """--profile-dir traces the profiled steps with the program's spans
    and writes their lane counters beside the trace."""
    prof = tmp_path / "prof"
    _invert(tmp_path, "--config", "1", "--steps", "5", "--profile-dir",
            str(prof))
    with open(prof / "invert_trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"yhair.step", "yhair.bounce", "yhair.adam"} <= names
    with open(prof / "counters.json") as f:
        counts = json.load(f)
    for kind in ("bounce", "shadow"):
        lanes, live = (counts[f"rays.{kind}_lanes"],
                       counts[f"rays.{kind}_live"])
        assert lanes >= live > 0
    # the three profiled steps: 128 pixels, 1 spp, 2 bounces each
    assert counts["rays.bounce_lanes"] == 3 * 128 * 2


def test_build_device_scene_backends(hairball):
    # auto: the BVH on a CPU device (the cluster search on the card), as
    # the reference picks by platform
    sc, _ = common.build_device_scene(*hairball, accel="auto", device="cpu")
    assert isinstance(sc.accel, DeviceBVH) and sc.accel.leaf_size == 4
    sc, _ = common.build_device_scene(*hairball, accel="bvh", leaf_size=8,
                                      device="cpu")
    assert isinstance(sc.accel, DeviceBVH) and sc.accel.leaf_size == 8
    sc, _ = common.build_device_scene(*hairball, accel="cluster",
                                      device="cpu")
    assert isinstance(sc.accel, Clusters)
    for kw in ({"accel": "brute"}, {"use_bvh": False}):
        sc, _ = common.build_device_scene(*hairball, device="cpu", **kw)
        assert sc.accel is None
    sc, _ = common.build_device_scene(*gen.single_strand(), accel="cluster",
                                      device="cpu")
    assert sc.accel is None          # <= 64 segments: brute force
    with pytest.raises(ValueError, match="unknown accel"):
        common.build_device_scene(*hairball, accel="kd", device="cpu")


def _convert_inputs(d):
    rng = np.random.default_rng(0)
    counts = np.array([3, 2, 4, 3])
    pts = rng.normal(size=(int((counts + 1).sum()), 3))
    rhair.save(str(d / "w.hair"), pts, counts,
               rng.uniform(1e-3, 3e-3, len(pts)))
    rconvert.main(["hair2ply", str(d / "w.hair"), str(d / "w.ply")])
    mesh = gen.icosphere(radius=0.4, subdiv=1)
    robj.save_mesh(str(d / "m.obj"), mesh["positions"], mesh["triangles"],
                   normals=mesh["normals"],
                   texcoords=rng.random((len(mesh["positions"]), 2)))
    rconvert.main(["obj2ply", str(d / "m.obj"), str(d / "m.ply")])


@pytest.mark.parametrize("cmd", [
    ["hair2ply", "w.hair", "out.ply"],
    ["hair2ply", "w.hair", "out.ply", "--decimate", "2", "--radius-scale",
     "1.5"],
    ["ply2hair", "w.ply", "out.hair"],
    ["genscene", "curly_hairball", "out/scene.json", "--kwargs",
     '{"n_strands": 40, "n_seg": 3}'],
    ["obj2ply", "m.obj", "out.ply"],
    ["ply2obj", "m.ply", "out.obj"]])
def test_convert_writes_the_references_files(tmp_path, cmd):
    _convert_inputs(tmp_path)
    outs = {}
    for who, main in (("ref", rconvert.main), ("port", convert.main)):
        d = tmp_path / who
        (d / "out").mkdir(parents=True)
        src = cmd[1] if cmd[0] == "genscene" else str(tmp_path / cmd[1])
        main([cmd[0], src, str(d / cmd[2]), *cmd[3:]])
        outs[who] = {os.path.relpath(p, d): open(p, "rb").read()
                     for p in glob.glob(str(d / "**"), recursive=True)
                     if os.path.isfile(p)}
    assert outs["port"] == outs["ref"] and outs["port"]


def test_view_smoke(tmp_path, capsys):
    """``tests/test_view.py``'s smoke test: previews after each pass, an
    edits file applied, unknown keys reported."""
    out, edits = tmp_path / "view.png", tmp_path / "edits.json"
    argv = ["--config", "1", "--resolution", "32", "--bounces", "2",
            "--output", str(out), "--edits", str(edits), "--accel", "brute",
            "--device", "cpu"]
    view.main([*argv, "--max-passes", "2"])
    img1 = img_io.load_png(out)
    assert img1.shape == (32, 32, 3) and np.isfinite(img1).all()
    edits.write_text(json.dumps({"melanin": [1.3, 0.2], "beta_m": 0.15,
                                 "exposure": 0.5, "bogus_key": 1}))
    view.main([*argv, "--max-passes", "3"])
    cap = capsys.readouterr().out
    assert "ignoring unknown edit key 'bogus_key'" in cap
    assert "pass 3: 3 spp" in cap
    assert not np.array_equal(img_io.load_png(out), img1)
    # --max-spp ends the run at whole passes
    view.main([*argv, "--max-spp", "4", "--spp-per-pass", "2"])
    assert "final preview" in capsys.readouterr().out.splitlines()[-1]


def test_view_edits_match_the_reference():
    """_apply_edits: the melanin edit gives the reference's full-colour
    sigma_a; every other key lands where the reference puts it."""
    scene_d, cam_d = gen.single_strand()
    sc, _ = common.build_device_scene(scene_d, cam_d, device="cpu")
    edits = {"melanin": [1.3, 0.2], "beta_n": 0.4, "cam_from": [0, 1, 2],
             "fov": 20, "aperture": 0.1, "exposure": 0.5, "filmic": True}
    tm0 = {"exposure": 0.0, "filmic": False}
    sc2, cd, cam, tm = view._apply_edits(edits, sc, cam_d, dict(tm0))
    rsc2, rcd, rcam, rtm = rview._apply_edits(
        edits, jscene.from_dict(scene_d), cam_d, dict(tm0))
    sa = sc2.hair.sigma_a.numpy()
    assert sa.shape == (3,) and not np.allclose(sa, sa[0])
    np.testing.assert_array_equal(sa, np.asarray(rsc2.hair.sigma_a))
    assert float(sc2.hair.beta_n) == float(rsc2.hair.beta_n)
    assert cd == rcd and tm == rtm
    for k in ("position", "vfov_deg", "aperture", "focus_dist"):
        np.testing.assert_array_equal(getattr(cam, k).numpy(),
                                      np.asarray(getattr(rcam, k)))
    sc3, *_ = view._apply_edits({"color": [0.5, 0.3, 0.2]}, sc, cam_d,
                                dict(tm0))
    rsc3, *_ = rview._apply_edits({"color": [0.5, 0.3, 0.2]},
                                  jscene.from_dict(scene_d), cam_d,
                                  dict(tm0))
    np.testing.assert_allclose(sc3.hair.sigma_a.numpy(),
                               np.asarray(rsc3.hair.sigma_a), rtol=1e-6)
