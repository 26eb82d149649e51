"""The search layer's two seams, on the CPU.

The launch seam: ``yhair_tpu_torch/kernels.py``'s table of C entry
points against the ``extern "C"`` parameter lists of ``csrc/*.cu``,
and ``kernels.launch`` against a fake library (no card or nvcc needed).
The backend seam: the integrator reaches every segment search through
``scene.accel``, and the brute-force scan, the clusters, posed instances
and the BVH give one small scene the same hits and occlusion.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from scenes import generators as gen
from yhair_tpu_torch import kernels
from yhair_tpu_torch.accel import build_scene_bvh
from yhair_tpu_torch.accel.instanced import build_instanced
from yhair_tpu_torch.core import scene as tscene
from yhair_tpu_torch.integrator import path as tpath
from yhair_tpu_torch.ops import build_scene_clusters

PATH_PY = Path(tpath.__file__)
SOURCE = "".join(f.read_text() for f in kernels.SOURCES)
EXTERN = re.compile(r'extern "C" (\w+) (\w+)\(([^)]*)\)')


def _kind(param):
    """The table's kind of one C parameter declaration."""
    if param == "void* stream":
        return "s"
    if "*" in param:
        return "p"
    return {"int": "i", "float": "f"}[param.split()[0]]


@pytest.mark.parametrize("entry", sorted(kernels.ENTRIES))
def test_table_matches_the_extern_c_entry(entry):
    """Each row's argument kinds are its entry point's parameter list, in
    order, and every entry point of the source has a row."""
    found = {name: (ret, params) for ret, name, params
             in EXTERN.findall(SOURCE)}
    assert set(found) == set(kernels.ENTRIES)
    ret, params = found[entry]
    kinds = "".join(_kind(" ".join(p.split()))
                    for p in params.split(",") if p.strip())
    assert ret == "int"
    assert kinds == kernels.ENTRIES[entry][0]


class FakeLibrary:
    """Stands for the CUDA library: records each call, returns ``err``."""

    def __init__(self):
        self.calls, self.err = [], 0

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return self.err
        return call


class FakeStream:
    cuda_stream = 77


def test_launch_maps_arguments_raises_and_counts(monkeypatch):
    fake = FakeLibrary()
    monkeypatch.setattr(kernels, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: FakeStream())
    for k in kernels.LAUNCHES:
        monkeypatch.setitem(kernels.LAUNCHES, k, 0)
    o, d, dist = torch.zeros(256, 3), torch.ones(256, 3), torch.ones(256)
    v = [torch.full((5, 3), float(i)) for i in range(3)]
    occ = torch.zeros(256, dtype=torch.bool)

    kernels.launch("yhair_tri_any", o, d, dist, *v, 256, 5, 1e-4, occ)
    assert fake.calls == [("yhair_tri_any", (
        o.data_ptr(), d.data_ptr(), dist.data_ptr(),
        *(x.data_ptr() for x in v), 256, 5, 1e-4, occ.data_ptr(), 77))]
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0),
                                "tri_any_kernel": 1}

    # None is NULL (the lists kernel's absent t_max, exclude, scratch, key)
    ids = torch.zeros(2, 4, dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    kernels.launch("yhair_block_lists", o, d, v[0], v[1], None, None, 2, 5,
                   8, None, ids, counts, None)
    _, args = fake.calls[-1]
    assert args[4:10] == (None, None, 2, 5, 8, None)
    assert args[-1] == 77 and kernels.LAUNCHES["lists_kernel"] == 1

    # a nonzero return raises, names the kernel and the error, counts not
    fake.err = 700
    with pytest.raises(RuntimeError, match="tri_any_kernel.*CUDA error 700"):
        kernels.launch("yhair_tri_any", o, d, dist, *v, 256, 5, 1e-4, occ)
    assert kernels.LAUNCHES["tri_any_kernel"] == 1

    # arguments that do not fit the row are refused before any call
    n_calls = len(fake.calls)
    for args in [(o, d, dist, *v, 256, 5, 1e-4),             # one short
                 (o, d, dist, *v, 256.0, 5, 1e-4, occ),      # float for int
                 (o, d, dist, *v, 256, 5, torch.ones(1), occ),   # tensor
                 (o, d, dist, *v, 256, 5, 1e-4, 1)]:         # int for ptr
        with pytest.raises(TypeError):
            kernels.launch("yhair_tri_any", *args)
    with pytest.raises(TypeError):
        kernels.launch("yhair_tri_lanes", 256, 5)   # a query, not a kernel
    assert len(fake.calls) == n_calls


def test_library_is_named_by_every_source_and_the_flags(monkeypatch,
                                                       tmp_path):
    """``kernels.SOURCES`` is every CUDA source in ``csrc/``; an edit to
    any of them, or to the flags, names another library, so it
    rebuilds."""
    csrc = kernels.SOURCES[0].parent
    assert set(kernels.SOURCES) == (set(csrc.glob("*.cu"))
                                    | set(csrc.glob("*.cuh")))
    copies = [tmp_path / f.name for f in kernels.SOURCES]
    for f, c in zip(kernels.SOURCES, copies):
        c.write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "SOURCES", tuple(copies))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    names = {kernels.library_path()}
    for c in copies:
        c.write_bytes(c.read_bytes() + b"\n// edited\n")
        names.add(kernels.library_path())
    monkeypatch.setattr(kernels, "NVCC_FLAGS",
                        [*kernels.NVCC_FLAGS, "-lineinfo"])
    names.add(kernels.library_path())
    assert len(names) == len(copies) + 2
    assert all(n.parent == tmp_path / "build" for n in names)


def test_build_finds_a_built_library_without_nvcc(monkeypatch, tmp_path):
    """A process that finds the library compiles nothing: build returns
    it and an empty log without running nvcc."""
    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc ran")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.subprocess, "run", no_nvcc)
    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    lib = kernels.library_path()
    lib.write_bytes(b"")
    assert kernels.build() == (lib, "")
    lib.unlink()
    with pytest.raises(AssertionError, match="nvcc ran"):
        kernels.build()


def test_hair_kernel_is_declared_once():
    """The hair kernel's entry has its row and its own LAUNCHES key."""
    keys = [key for _, key in kernels.ENTRIES.values() if key]
    assert kernels.ENTRIES["yhair_hair_shade"][1] == "hair_kernel"
    assert keys.count("hair_kernel") == 1 and "hair_kernel" in \
        kernels.LAUNCHES


BACKEND_IMPORTS = ("accel", "instanced", "traverse", "intersect_kernel",
                   "clusters", "ops")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            yield from (node.module or "").split(".")
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.Import):
            for a in node.names:
                yield from a.name.split(".")


@pytest.fixture(scope="module")
def backends():
    """One small hairball behind each of the four segment searches."""
    scene_d, _ = gen.curly_hairball(n_strands=150, n_seg=8)
    brute = tscene.from_dict(scene_d, device="cpu")
    flat, cl = build_scene_clusters(brute, device="cpu")
    inst = flat._replace(accel=build_instanced(cl, [np.eye(4, 3)],
                                               device="cpu"))
    bvh, _ = build_scene_bvh(brute, device="cpu")
    assert brute.accel is None
    return {"brute": brute, "clusters": flat, "instanced": inst, "bvh": bvh}


def test_integrator_asks_only_scene_accel(backends):
    """integrator/path.py imports no backend module and names no backend
    type; intersect_scene and occluded_scene give one scene the same
    answers through each backend, with and without a ray permutation."""
    text = PATH_PY.read_text()
    assert not set(_imported(ast.parse(text))) & set(BACKEND_IMPORTS)
    assert not re.search(r"Clusters|DeviceBVH|InstancedClusters", text)

    rng = np.random.default_rng(4)
    o = rng.normal(size=(384, 3)) * 2.0
    d = rng.normal(size=(384, 3)) * 0.2 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.as_tensor(o, dtype=torch.float32)
    d = torch.as_tensor(d, dtype=torch.float32)
    dist = torch.as_tensor(rng.uniform(0.5, 4.0, 384), dtype=torch.float32)
    perm = torch.as_tensor(rng.permutation(384))

    want = tpath.intersect_scene(backends["brute"], o, d)
    want_occ = tpath.occluded_scene(backends["brute"], o, d, dist)
    assert int((want.hit & (want.mat == 0)).sum()) > 20
    assert 20 < int(want_occ.sum()) < 364
    for name, sc in backends.items():
        for p in (None, perm):
            hs = tpath.intersect_scene(sc, o, d, perm=p)
            assert torch.equal(hs.hit, want.hit), name
            assert torch.equal(hs.mat, want.mat), name
            assert torch.equal(hs.hair_mid, want.hair_mid), name
            torch.testing.assert_close(hs.t, want.t, rtol=1e-5, atol=0)
            torch.testing.assert_close(hs.position, want.position,
                                       rtol=1e-5, atol=1e-6)
            occ = tpath.occluded_scene(sc, o, d, dist, perm=p)
            assert torch.equal(occ, want_occ), name
