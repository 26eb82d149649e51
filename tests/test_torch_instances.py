"""Port vs reference: posed instances of one cluster build.

After ``tests/test_instances.py``, on its 120-strand wig and frames:
- ``frame_matrix`` and ``transform_segments`` equal the reference's;
- ``build_instanced`` gives the reference's fields bit for bit (the
  reference's instanced structure handed over through
  ``convert.instanced_from_numpy``);
- two instances (two hair materials) and four (with the top-level
  cull) render like the reference's instanced render (its Pallas kernel
  in interpret mode) and like the port's own baked scene (the posed
  copies flattened into one cluster build): the reference's gate, >= 97%
  of the values within rtol = atol = 5e-3, and the matched values within
  5e-3 (measured: every value within, >= 98.8% of the pixels within
  1e-4);
- the near clip acts at world distance T_MIN under a scale of 8;
- rays that miss every instance's box neither hit nor are occluded.
The training step on the all-features scene, instances included, is
``tests/test_torch_full_feature.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu.accel import instanced as jinst
from yhair_tpu.core import scene as jscene
from yhair_tpu.geometry.segments import Segments as JSegments
from yhair_tpu.integrator import path as jpath
from yhair_tpu.io import scene_json as jio
from yhair_tpu.ops import clusters as jcmod
from yhair_tpu_torch import convert
from yhair_tpu_torch.accel import instanced as tinst
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.core.rng import n_uniform_dims
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.io import scene_json as tio
from yhair_tpu_torch.ops import build_scene_clusters

torch.set_num_threads(1)

RES, SPP, DEPTH = 16, 1, 2
_C, _S = np.cos(np.deg2rad(40.0)), np.sin(np.deg2rad(40.0))
FRAMES = [
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]],
    [[_C * 1.1, 0, -_S * 1.1], [0, 1.1, 0], [_S * 1.1, 0, _C * 1.1],
     [0.35, 0.0, 0.1]],
]
FRAMES4 = FRAMES + [
    [[0.8, 0, 0], [0, 0.8, 0], [0, 0, 0.8], [-0.8, 0.1, -0.2]],
    [[0, 1, 0], [-1, 0, 0], [0, 0, 1], [0.8, -0.1, -0.3]],
]
CASES = {2: (FRAMES, [0, 1]), 4: (FRAMES4, None)}


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    # the reference's Pallas re-execution can trip over executables that
    # earlier files in the same process cached (ADVICE.md, test_instances)
    jax.clear_caches()
    yield


def _materials(scene_d):
    m = scene_d["hair_material"]
    return [m, dict(m, beta_m=min(0.9, m["beta_m"] * 1.6))]


@pytest.fixture(scope="module")
def wig():
    scene_d, cam_d = gen.hair_patch(n_strands=120, n_seg=4)
    table = dict(scene_d, hair_materials=_materials(scene_d),
                 segment_mat_id=np.zeros(len(scene_d["segments"][0]),
                                         np.int64))
    sc_cl, cl = build_scene_clusters(tscene.from_dict(table, device="cpu"),
                                     device="cpu", use_native=False)
    # from the float32 segments the port's scene holds
    jcl = jcmod.build(*(np.asarray(a, np.float32)
                        for a in scene_d["segments"]), use_native=False)
    return dict(scene_d=scene_d, cam_d=cam_d, table=table, sc_cl=sc_cl, cl=cl,
                jcl=jcl, cam=tscene.camera_from_dict(cam_d, device="cpu"))


def test_frame_matrix_and_transform_match_reference(wig):
    for fr in FRAMES4:
        for a, b in zip(tio.frame_matrix(fr), jio.frame_matrix(fr)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tio.transform_segments(wig["scene_d"]["segments"], fr),
                        jio.transform_segments(wig["scene_d"]["segments"],
                                               fr)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tio.frame_matrix([[2, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]])


@pytest.mark.parametrize("n_inst", sorted(CASES))
def test_build_instanced_matches_reference(wig, n_inst):
    frames, mats = CASES[n_inst]
    want = convert.instanced_from_numpy(convert.flat_fields(
        jinst.build_instanced(wig["jcl"], frames, inst_mat=mats)),
        device="cpu")
    got = tinst.build_instanced(wig["cl"], frames, inst_mat=mats,
                                device="cpu")
    want, got = convert.flat_fields(want), convert.flat_fields(got)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def _baked(scene_d, frames, with_materials):
    parts = [tio.transform_segments(scene_d["segments"], fr) for fr in frames]
    baked = dict(scene_d, segments=tuple(
        np.concatenate([p[k] for p in parts]) for k in range(4)))
    if with_materials:
        baked.update(hair_materials=_materials(scene_d),
                     segment_mat_id=np.concatenate(
                         [np.full(len(p[0]), i) for i, p in enumerate(parts)]))
    return baked


@pytest.mark.parametrize("n_inst", sorted(CASES))
def test_instanced_render_matches_reference_and_baked(wig, n_inst):
    frames, mats = CASES[n_inst]
    scene_d = wig["table"] if mats else wig["scene_d"]
    u = np.random.default_rng(n_inst).random(
        (RES, RES, SPP, n_uniform_dims(DEPTH))).astype(np.float32)
    # the port: one cluster build, posed
    sc = wig["sc_cl"]
    if not mats:
        sc = sc._replace(hair=type(sc.hair)(*(a[0] for a in sc.hair)))
    sc = sc._replace(accel=tinst.build_instanced(wig["cl"], frames,
                                                 inst_mat=mats, device="cpu"))
    got = tpath.render(sc, wig["cam"], torch.as_tensor(u), max_depth=DEPTH,
                       device="cpu").numpy()
    # the reference, as tests/test_instances.py builds it
    jcl = wig["jcl"]
    jsc = jscene.from_dict(scene_d)._replace(
        segments=JSegments(p0=jcl.s0[:, :3], p1=jcl.s1[:, :3],
                           r0=jcl.s0[:, 3], r1=jcl.s1[:, 3]),
        accel=jinst.build_instanced(jcl, frames, inst_mat=mats))
    want = np.asarray(jpath.render(jsc, jscene.camera_from_dict(wig["cam_d"]),
                                   jnp.asarray(u), max_depth=DEPTH))
    # the port's baked scene: the posed copies as one flat soup
    baked, _ = build_scene_clusters(tscene.from_dict(
        _baked(wig["scene_d"], frames, bool(mats)), device="cpu"),
        device="cpu")
    flat = tpath.render(baked, wig["cam"], torch.as_tensor(u),
                        max_depth=DEPTH, device="cpu").numpy()
    single = tpath.render(wig["sc_cl"], wig["cam"], torch.as_tensor(u),
                          max_depth=DEPTH, device="cpu").numpy()
    assert np.isfinite(got).all()
    # the posed copies add coverage
    assert (np.abs(got - single) > 1e-3).mean() > 0.02
    for other in (want, flat):
        close = np.isclose(got, other, rtol=5e-3, atol=5e-3)
        assert close.mean() > 0.97, f"only {close.mean():.3f} close"
        assert np.abs((got - other)[close]).max() < 5e-3


def test_near_clip_is_world_t_min_at_any_scale():
    """``tests/test_instances.py:184``: a strand at 4e-4 world units
    under a scale of 8 is hit (the old clip was scale * T_MIN)."""
    p0, p1, r = (np.array([[-0.5, 0.0, 0.0]]), np.array([[0.5, 0.0, 0.0]]),
                 np.array([1e-3]))
    sc, cl = build_scene_clusters(tscene.from_dict(
        {"segments": (p0, p1, r, r), "hair_material": gen.DEFAULT_HAIR},
        device="cpu"), device="cpu", use_native=False)
    ic = tinst.build_instanced(cl, [[[8, 0, 0], [0, 8, 0], [0, 0, 8],
                                     [0, 0, 0]]], device="cpu")
    o = torch.tensor([[0.0, 4e-4, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]])
    t, _, hit = tinst.make_nearest_fn(ic, device="cpu")(o, d)
    assert bool(hit[0]) and abs(float(t[0]) - 4e-4) < 1e-4
    jic = jinst.build_instanced(jcmod.build(p0, p1, r, r, use_native=False),
                                [[[8, 0, 0], [0, 8, 0], [0, 0, 8],
                                  [0, 0, 0]]])
    tj, _, _ = jinst.make_nearest_fn(jic, interpret=True)(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    np.testing.assert_allclose(float(t[0]), float(tj[0]), rtol=1e-5)


def test_rays_missing_every_box(wig):
    ic = tinst.build_instanced(wig["cl"], FRAMES4, device="cpu")
    o = torch.tensor([[0.0, 5.0, 0.0]]).repeat(8, 1)
    d = torch.tensor([[0.0, 1.0, 0.0]]).repeat(8, 1)
    _, _, hit = tinst.make_nearest_fn(ic, device="cpu")(o, d)
    occ = tinst.make_occluded_fn(ic, device="cpu")(o, d,
                                                   torch.full((8,), 100.0))
    assert not bool(hit.any()) and not bool(occ.any())
