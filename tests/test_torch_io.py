"""Port vs reference: file io and the mesh shape operations.

The port keeps its own numpy copies of ``yhair_tpu/io`` and
``yhair_tpu/geometry/shape_ops.py``. Each writer must produce the
reference's bytes for the same inputs (PNG, whose encoders differ, is
compared decoded by PIL), each loader must return the reference's arrays
from the same file, and ``scene_json.load`` the reference's dicts, with
equal dtypes, for every kind of scene file. Inputs are made with numpy
from a seed.
"""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from scenes import generators as gen
from yhair_tpu.geometry import shape_ops as rshape
from yhair_tpu.io import exr as rexr
from yhair_tpu.io import hairfile as rhair
from yhair_tpu.io import image as rimage
from yhair_tpu.io import obj as robj
from yhair_tpu.io import ply as rply
from yhair_tpu.io import scene_json as rscene
from yhair_tpu_torch.geometry import shape_ops as tshape
from yhair_tpu_torch.io import exr as texr
from yhair_tpu_torch.io import hairfile as thair
from yhair_tpu_torch.io import image as timage
from yhair_tpu_torch.io import obj as tobj
from yhair_tpu_torch.io import ply as tply
from yhair_tpu_torch.io import scene_json as tscene


def assert_same(a, b, where="root"):
    """Equal nested dicts/lists/tuples of arrays and scalars: the same
    keys, the same dtypes and shapes, equal values bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def _strands(seed, n=20):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    r = rng.uniform(1e-3, 1e-2, n)
    lines = np.stack([np.arange(n - 1), np.arange(n - 1) + 1], axis=-1)
    return v, r, lines


def _ascii_strands(path, v, r, lines):
    rows = [f"{x} {y} {z} {q}" for (x, y, z), q in zip(v, r)]
    rows += [f"{a} {b}" for a, b in lines]
    path.write_text("\n".join([
        "ply", "format ascii 1.0", f"element vertex {len(v)}",
        "property float x", "property float y", "property float z",
        "property float radius", f"element line {len(lines)}",
        "property int vertex1", "property int vertex2", "end_header",
        *rows, ""]))


@pytest.mark.parametrize("fmt", ["binary", "ascii", "list"])
def test_ply_strands(tmp_path, fmt):
    v, r, lines = _strands(0)
    a, b = tmp_path / "ref.ply", tmp_path / "port.ply"
    if fmt == "binary":
        rply.save_strands(a, v, r, lines)
        tply.save_strands(b, v, r, lines)
        assert read(a) == read(b)
    elif fmt == "ascii":
        _ascii_strands(b, v, r, lines)
    else:
        # one polyline per strand as a list property (binary)
        header = "\n".join([
            "ply", "format binary_little_endian 1.0",
            f"element vertex {len(v)}", "property float x",
            "property float y", "property float z", "property float radius",
            "element line 2", "property list uchar int vertex_indices",
            "end_header"]) + "\n"
        body = np.concatenate([v, r[:, None]], 1).astype("<f4").tobytes()
        for idx in (np.arange(0, 8), np.arange(8, 20)):
            body += bytes([len(idx)]) + idx.astype("<i4").tobytes()
        b.write_bytes(header.encode() + body)
    want = rply.load_strands(b)
    got = tply.load_strands(b)
    assert_same(got, want)
    assert_same(tply.lines_to_segments(*got), rply.lines_to_segments(*want))


@pytest.mark.parametrize("normals", [False, True])
def test_ply_mesh(tmp_path, normals):
    mesh = gen.icosphere(radius=0.4, subdiv=1)
    nrm = mesh["normals"] if normals else None
    a, b = tmp_path / "ref.ply", tmp_path / "port.ply"
    rply.save_mesh(a, mesh["positions"], mesh["triangles"], nrm)
    tply.save_mesh(b, mesh["positions"], mesh["triangles"], nrm)
    assert read(a) == read(b)
    assert_same(tply.load_mesh(b), rply.load_mesh(b))
    # an ascii mesh with a quad face (fan-triangulated)
    c = tmp_path / "ascii.ply"
    c.write_text("\n".join([
        "ply", "format ascii 1.0", "element vertex 4", "property float x",
        "property float y", "property float z", "element face 1",
        "property list uchar int vertex_indices", "end_header",
        "0 0 0", "1 0 0", "1 1 0", "0 1 0", "4 0 1 2 3", ""]))
    assert_same(tply.load_mesh(c), rply.load_mesh(c))


@pytest.mark.parametrize("thickness", [False, True])
def test_hairfile(tmp_path, thickness):
    rng = np.random.default_rng(1)
    counts = np.array([4, 2, 5])
    pts = rng.normal(size=(int((counts + 1).sum()), 3))
    th = rng.uniform(1e-3, 5e-3, len(pts)) if thickness else None
    a, b = tmp_path / "ref.hair", tmp_path / "port.hair"
    rhair.save(a, pts, counts, th)
    thair.save(b, pts, counts, th)
    assert read(a) == read(b)
    got, want = thair.load(b), rhair.load(b)
    assert_same(got, want)
    assert_same(thair.to_segments(got, 1.5), rhair.to_segments(want, 1.5))


@pytest.mark.parametrize("normals,texcoords", [
    (False, False), (True, False), (False, True), (True, True)])
def test_obj(tmp_path, normals, texcoords):
    mesh = gen.icosphere(radius=0.4, subdiv=1)
    rng = np.random.default_rng(2)
    kw = dict(normals=mesh["normals"] if normals else None,
              texcoords=(rng.random((len(mesh["positions"]), 2))
                         if texcoords else None))
    a, b = tmp_path / "ref.obj", tmp_path / "port.obj"
    robj.save_mesh(a, mesh["positions"], mesh["triangles"], **kw)
    tobj.save_mesh(b, mesh["positions"], mesh["triangles"], **kw)
    assert read(a) == read(b)
    assert_same(tobj.load_mesh(b), robj.load_mesh(b))
    # negative (relative) indices and a quad face
    c = tmp_path / "rel.obj"
    c.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\n"
                 "vt 0 0\nvt 1 1\nf -4/1/1 -3/2/1 -2/2/1 -1/1/1\n")
    assert_same(tobj.load_mesh(c), robj.load_mesh(c))


def _hdr_image(seed, shape=(9, 13, 3)):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 4.0, shape)
    img[0, 0] = 0.0                      # a black pixel (RGBE exponent 0)
    return img


@pytest.mark.parametrize("suffix", [".pfm", ".hdr", ".npy", ".exr"])
def test_hdr_files(tmp_path, suffix):
    img = _hdr_image(3)
    a, b = tmp_path / f"ref{suffix}", tmp_path / f"port{suffix}"
    rimage.save_hdr(str(a), img)
    timage.save_hdr(str(b), img)
    assert read(a) == read(b)
    assert_same(timage.load_hdr(str(b)), rimage.load_hdr(str(b)))


@pytest.mark.parametrize("compression", [0, 2, 3])
@pytest.mark.parametrize("gray", [False, True])
def test_exr(tmp_path, compression, gray):
    img = _hdr_image(4, (33, 47) if gray else (33, 47, 3)).astype(np.float32)
    a, b = tmp_path / "ref.exr", tmp_path / "port.exr"
    rexr.save_exr(str(a), img, compression=compression)
    texr.save_exr(str(b), img, compression=compression)
    assert read(a) == read(b)
    got = texr.load_exr(str(b))
    assert_same(got, rexr.load_exr(str(b)))
    np.testing.assert_array_equal(got.astype(np.float32), img)
    raw = np.random.default_rng(5).integers(0, 256, 999,
                                            dtype=np.uint8).tobytes()
    assert texr._zip_filter(raw) == rexr._zip_filter(raw)
    assert texr._zip_unfilter(texr._zip_filter(raw)) == raw


def _rle_scanline(row):
    """A new-style RLE scanline of an (W, 4) uint8 row: each channel as
    one run of its first byte's repeats, then literals."""
    out = bytes([2, 2, len(row) >> 8, len(row) & 0xFF])
    for c in range(4):
        ch = row[:, c]
        n = 1
        while n < len(ch) and n < 127 and ch[n] == ch[0]:
            n += 1
        out += bytes([128 + n, int(ch[0])])
        rest = ch[n:]
        for i in range(0, len(rest), 128):
            out += bytes([len(rest[i:i + 128])]) + rest[i:i + 128].tobytes()
    return out


def test_radiance_hdr_rle(tmp_path):
    img = _hdr_image(6, (5, 12, 3))
    img[:, :4] = 1.5                      # runs at the start of each row
    rgbe = rimage._float_to_rgbe(img)
    np.testing.assert_array_equal(timage._float_to_rgbe(img), rgbe)
    p = tmp_path / "rle.hdr"
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n"
                  + b"".join(_rle_scanline(r) for r in rgbe))
    assert_same(timage.load_radiance_hdr(p), rimage.load_radiance_hdr(p))
    np.testing.assert_array_equal(timage.load_radiance_hdr(p),
                                  rimage._rgbe_to_float(rgbe))


@pytest.mark.parametrize("exposure,filmic", [(0.0, False), (1.0, True)])
def test_png_decodes_as_the_references(tmp_path, exposure, filmic):
    img = _hdr_image(7, (10, 14, 3))
    a, b = tmp_path / "ref.png", tmp_path / "port.png"
    rimage.save_png(a, img, exposure, filmic)
    timage.save_png(b, img, exposure, filmic)
    ref = np.asarray(Image.open(a))
    np.testing.assert_array_equal(np.asarray(Image.open(b)), ref)
    np.testing.assert_array_equal(timage.decode_png(read(a)), ref)
    assert_same(timage.load_png(a), rimage.load_png(a))
    assert_same(timage.load_png(b, to_linear=False),
                rimage.load_png(a, to_linear=False))


def _filter_row(ftype, row, prior, bpp):
    """PNG filter ``ftype`` of one scanline (the encoder's side), in
    plain Python."""
    out = []
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) & 0xFF)
    return bytes([ftype] + out)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_filters_and_formats(channels):
    """Rows under each of the five filters, in gray, RGB and RGBA: the
    port's decoder reads what PIL reads; its encoder writes what PIL
    reads back."""
    rng = np.random.default_rng(8)
    ldr = rng.integers(0, 256, (10, 7, channels), dtype=np.uint8)
    ldr[:, :3] = ldr[:, :1]              # some repeats for Sub / Paeth
    h, w, c = ldr.shape
    ctype = {1: 0, 3: 2, 4: 6}[channels]
    raw, prior = b"", bytes(w * c)
    for y in range(h):
        row = ldr[y].tobytes()
        raw += _filter_row(y % 5, row, prior, c)
        prior = row
    png = (timage.PNG_SIGNATURE
           + timage._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                    ctype, 0, 0, 0))
           + timage._png_chunk(b"IDAT", zlib.compress(raw))
           + timage._png_chunk(b"IEND", b""))
    want = ldr[..., 0] if channels == 1 else ldr
    import io
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  want)
    np.testing.assert_array_equal(timage.decode_png(png), want)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(timage.encode_png(want)))), want)


def test_image_functions():
    img = _hdr_image(9, (12, 20, 3))
    x = np.linspace(-0.5, 1.5, 41)
    assert_same(timage.srgb_encode(x), rimage.srgb_encode(x))
    assert_same(timage.srgb_decode(x), rimage.srgb_decode(x))
    for kw in ({}, {"exposure": 1.5}, {"filmic": True},
               {"exposure": -1.0, "filmic": True, "srgb": False}):
        assert_same(timage.tonemap(img, **kw), rimage.tonemap(img, **kw))
    assert_same(timage.resize(img, 24, 7), rimage.resize(img, 24, 7))
    assert_same(timage.resize(img[..., 0], 5, 31),
                rimage.resize(img[..., 0], 5, 31))


def test_jpg(tmp_path, monkeypatch):
    img = _hdr_image(10, (16, 16, 3)) * 0.2
    a, b = tmp_path / "ref.jpg", tmp_path / "port.jpg"
    rimage.save_jpg(str(a), img, quality=95)
    timage.save_jpg(str(b), img, quality=95)
    assert read(a) == read(b)
    assert_same(timage.load_jpg(str(b)), rimage.load_jpg(str(b)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG files need PIL"):
        timage.save_jpg(str(b), img)
    timage.save_png(tmp_path / "no_pil.png", img)   # PNG needs no PIL


def _unit_quad():
    return {"positions": np.array([[0, 0, 0], [1, 0, 0], [1, 0.5, 1],
                                   [0, 0, 1]], np.float64),
            "quads": np.array([[0, 1, 2, 3]])}


@pytest.mark.parametrize("op", [
    "quads_to_triangles", "compute_normals", "subdivide_mesh",
    "displace_callable", "displace_array", "displace_map"])
def test_shape_ops(op):
    mesh = gen.icosphere(radius=0.4, subdiv=1)
    nv = len(mesh["positions"])
    hmap = np.random.default_rng(11).random((6, 9, 3))
    calls = {
        "quads_to_triangles": lambda m: m.quads_to_triangles(_unit_quad()),
        "compute_normals": lambda m: m.compute_normals(
            {"positions": mesh["positions"],
             "triangles": mesh["triangles"]}),
        "subdivide_mesh": lambda m: m.subdivide_mesh(_unit_quad(), 2),
        "displace_callable": lambda m: m.displace_mesh(
            mesh, lambda p: np.sin(4 * p[:, 0]), scale=0.1),
        "displace_array": lambda m: m.displace_mesh(
            {"positions": mesh["positions"],
             "triangles": mesh["triangles"]}, np.linspace(0, 1, nv)),
        "displace_map": lambda m: m.displace_mesh(mesh, hmap, scale=0.05),
    }
    assert_same(calls[op](tshape), calls[op](rshape))


# scene files: (name, JSON document, assets written first)
def _assets(d):
    rng = np.random.default_rng(12)
    mesh = gen.icosphere(radius=0.4, subdiv=1)
    robj.save_mesh(d / "ball.obj", mesh["positions"], mesh["triangles"],
                   normals=mesh["normals"])
    rply.save_mesh(d / "ball.ply", mesh["positions"], mesh["triangles"])
    v, r, lines = _strands(13)
    rply.save_strands(d / "wig.ply", v, r, lines)
    rhair.save(d / "wig.hair", rng.normal(size=(9, 3)), np.array([3, 4]),
               rng.uniform(1e-3, 3e-3, 9))
    img = rng.uniform(0.0, 4.0, (8, 16, 3))
    rimage.save_radiance_hdr(d / "light.hdr", img)
    rexr.save_exr(str(d / "light.exr"), img)
    rimage.save_pfm(d / "tex.pfm", img)
    rimage.save_png(d / "tex.png", img * 0.2)


SCENES = {
    "melanin_generator": {
        "camera": {"position": [0, 0, 2], "look_at": [0, 0, 0]},
        "hair_material": {"eumelanin": 1.3, "pheomelanin": 0.2},
        "strands": {"generator": "single_strand"},
        "environment": [0.1, 0.1, 0.1]},
    "color_ply_camera": {
        "camera": {"position": [0, 0.2, 2], "look_at": [0, 0, 0],
                   "up": [0, 1, 0], "vfov_deg": 30, "aperture": 0.05,
                   "focus_dist": 1.9},
        "hair_material": {"color": [0.5, 0.3, 0.2], "beta_n": 0.4,
                          "alpha_deg": 3.0, "eta": 1.5},
        "strands": {"ply": "wig.ply", "scale": 2.0, "offset": [0, 1, 0]},
        "spheres": [{"center": [0, 0, 0], "radius": 0.3,
                     "albedo": [0.3, 0.2, 0.1]}],
        "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                    "albedo": [0.5, 0.5, 0.5]}],
        "point_lights": [{"position": [2, 2, 2],
                          "intensity": [20, 20, 20]}]},
    "hair_file": {
        "strands": {"hair": "wig.hair", "radius_scale": 0.5},
        "hair_material": {"sigma_a": [0.2, 0.3, 0.4]}},
    "mesh_generator": {
        "strands": {"generator": "single_strand"},
        "meshes": [{"generator": "icosphere", "radius": 0.3, "subdiv": 1,
                    "scale": 2.0, "offset": [0, 1, 0],
                    "material": {"color": [0.5, 0.4, 0.3],
                                 "roughness": 0.5}}]},
    "mesh_files": {
        "strands": {"generator": "single_strand"},
        "meshes": [{"obj": "ball.obj", "offset": [0, 1, 0],
                    "material": {"color": [0.5, 0.4, 0.3]}},
                   {"ply": "ball.ply", "subdivide": 1, "albedo": [0.2] * 3}]},
    "quads_inline": {
        "strands": {"generator": "single_strand"},
        "meshes": [{"positions": [[0, -0.2, 0], [1, -0.2, 0], [1, -0.2, 1],
                                  [0, -0.2, 1]],
                    "quads": [[0, 1, 2, 3]], "albedo": [0.5, 0.5, 0.5]},
                   {"positions": [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    "triangles": [[0, 1, 2]],
                    "normals": [[0, 0, 1]] * 3, "subdivide": 2}]},
    "textures": {
        "strands": {"generator": "single_strand"},
        "textures": [{"file": "light.hdr"}, {"file": "light.exr"},
                     {"file": "tex.pfm"}, {"file": "tex.png"},
                     {"checker": {"h": 8, "w": 12, "tiles": 2}},
                     {"gradient": {"h": 4, "w": 5}},
                     {"data": [[[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]]]}],
        "env_map": {"file": "light.exr"}},
    "instances_multimaterial": {
        "strands": [
            {"ply": "wig.ply",
             "material": {"sigma_a": [0.1, 0.2, 0.3], "beta_m": 0.2},
             "instances": [[[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]],
                           [[0, 0, -1.2], [0, 1.2, 0], [1.2, 0, 0],
                            [0.3, 0, 0.1]]]},
            {"generator": "single_strand", "offset": [0.2, 0, 0],
             "material": {"eumelanin": 0.5}}]},
    "curves_list": {
        "strands": {"generator": "single_strand"},
        "curves": [{"cp": [[0, 0, 0], [0, 0.1, 0], [0, 0.2, 0.1],
                           [0, 0.3, 0]], "radius": 0.01, "mat_id": 0},
                   {"cp": [[0.1, 0, 0], [0.1, 0.1, 0], [0.1, 0.2, 0],
                           [0.1, 0.3, 0]], "r0": 0.02, "r1": 0.005}]},
    "curves_array": {
        "strands": {"generator": "single_strand"},
        "curves": {"cp": [[[0, 0, 0], [0, 0.1, 0], [0, 0.2, 0.1],
                           [0, 0.3, 0]]], "r0": [0.01], "r1": [0.002]}},
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_json_load(tmp_path, name):
    _assets(tmp_path)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(SCENES[name]))
    assert_same(tscene.load(path), rscene.load(path))


def _full_scene():
    """Two hair materials, a mesh with a material and one with an
    albedo, a texture, an env map and curves."""
    rng = np.random.default_rng(14)
    scene_d, cam_d = gen.single_strand()
    scene_d = dict(scene_d)
    p0, p1, r0, r1 = scene_d["segments"]
    scene_d["segments"] = tuple(np.concatenate([x, x + off]) for x, off in
                                ((p0, 0.2), (p1, 0.2), (r0, 0.0),
                                 (r1, 0.0)))
    m0 = scene_d["hair_material"]
    scene_d["hair_materials"] = [m0, dict(m0, beta_m=0.5)]
    scene_d["segment_mat_id"] = np.repeat([0, 1], len(p0))
    ball = gen.icosphere(radius=0.3, subdiv=1)
    scene_d["meshes"] = [dict(ball, material={"color": [0.5, 0.4, 0.3],
                                              "color_tex": 0}),
                         {"positions": ball["positions"] + 1.0,
                          "triangles": ball["triangles"],
                          "albedo": [0.2, 0.2, 0.2]}]
    scene_d["textures"] = [{"data": rng.random((4, 6, 3))}]
    scene_d["env_map"] = rng.random((4, 8, 3))
    scene_d["curves"] = {"cp": rng.random((2, 4, 3)),
                         "r0": np.array([0.01, 0.02]),
                         "r1": np.array([0.005, 0.01]),
                         "mat_id": np.array([0, 1])}
    cam_d = dict(cam_d, aperture=0.02, focus_dist=1.5)
    return scene_d, cam_d


@pytest.mark.parametrize("scene", ["full", "config3_small"])
def test_scene_json_save_writes_the_references_files(tmp_path, scene):
    if scene == "full":
        scene_d, cam_d = _full_scene()
    else:
        scene_d, cam_d = gen.curly_hairball(n_strands=50, n_seg=4)
    a, b = tmp_path / "ref", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    rscene.save(a / "scene.json", scene_d, cam_d)
    tscene.save(b / "scene.json", scene_d, cam_d)
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and len(files) > 1
    for f in files:
        assert read(a / f) == read(b / f), f
    assert_same(tscene.load(b / "scene.json"),
                rscene.load(a / "scene.json"))
