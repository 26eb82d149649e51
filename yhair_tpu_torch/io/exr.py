"""OpenEXR 2.0 reader and writer in numpy and zlib
(``yhair_tpu/io/exr.py``).

The subset renderers exchange, from the OpenEXR file-format spec:
single-part scanline images in increasing line order; channels R/G/B or
a single luminance channel, HALF or FLOAT; compression NONE, ZIPS (1
line per chunk) or ZIP (16 lines per chunk), the zlib deflate of the
spec's interleave-split and delta-predictor transform (ImfZip). Tiled,
deep, multi-part and PIZ/B44/DWA files raise.

The writer emits FLOAT channels with ZIP compression: a float32 image
round-trips bit for bit, and the bytes equal the reference writer's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
PT_UINT, PT_HALF, PT_FLOAT = 0, 1, 2
_PT_DTYPE = {PT_HALF: np.dtype("<f2"), PT_FLOAT: np.dtype("<f4"),
             PT_UINT: np.dtype("<u4")}
_COMP_LINES = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _zip_unfilter(data):
    """Inverse of the ImfZip transform: delta-decode then de-interleave."""
    b = np.frombuffer(data, np.uint8).astype(np.int64)
    d = np.empty_like(b)
    d[0] = b[0]
    d[1:] = b[1:] - 128
    b = np.cumsum(d) & 0xFF
    n = len(b)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = b[:half]
    out[1::2] = b[half:half + n // 2]
    return out.tobytes()


def _zip_filter(raw):
    """The ImfZip transform: interleave-split then delta-encode."""
    b = np.frombuffer(raw, np.uint8)
    n = len(b)
    half = (n + 1) // 2
    split = np.empty(n, np.uint8)
    split[:half] = b[0::2]
    split[half:] = b[1::2]
    s = split.astype(np.int64)
    d = np.empty_like(s)
    d[0] = s[0]
    d[1:] = (s[1:] - s[:-1] + 384) & 0xFF
    return d.astype(np.uint8).tobytes()


def _read_attrs(f):
    attrs = {}
    while True:
        name = b""
        while (c := f.read(1)) != b"\x00":
            if not c:
                raise ValueError("truncated EXR header")
            name += c
        if not name:
            return attrs
        typ = b""
        while (c := f.read(1)) != b"\x00":
            typ += c
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name.decode()] = (typ.decode(), f.read(size))


def _parse_chlist(data):
    chans = []
    i = 0
    while data[i] != 0:
        j = data.index(b"\x00", i)
        name = data[i:j].decode()
        ptype, = struct.unpack_from("<i", data, j + 1)
        xs, ys = struct.unpack_from("<ii", data, j + 9)
        if xs != 1 or ys != 1:
            raise ValueError("subsampled channels unsupported")
        chans.append((name, ptype))
        i = j + 17
    return chans


def load_exr(path):
    """-> (H, W, 3) float64 (or (H, W) for single-channel files)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != MAGIC:
            raise ValueError("not an EXR file")
        if version & 0x1A00:  # tiled / deep / multi-part flag bits
            raise ValueError("tiled/deep/multi-part EXR unsupported")
        attrs = _read_attrs(f)
        chans = _parse_chlist(attrs["channels"][1])
        comp = attrs["compression"][1][0]
        if comp not in _COMP_LINES:
            raise ValueError(f"compression {comp} unsupported "
                             "(NONE/ZIPS/ZIP only)")
        xmin, ymin, xmax, ymax = struct.unpack("<iiii",
                                               attrs["dataWindow"][1])
        w = xmax - xmin + 1
        h = ymax - ymin + 1
        lines_per = _COMP_LINES[comp]
        n_chunks = (h + lines_per - 1) // lines_per
        f.read(8 * n_chunks)  # offset table (chunks are sequential)

        per_px = sum(_PT_DTYPE[pt].itemsize for _, pt in chans)
        planes = {name: np.zeros((h, w), np.float64) for name, _ in chans}
        for _ in range(n_chunks):
            y, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            rows = min(lines_per, ymax - y + 1)
            raw_size = rows * w * per_px
            if comp and size < raw_size:
                data = _zip_unfilter(zlib.decompress(data))
            for r in range(rows):
                off = r * w * per_px
                for name, pt in chans:   # stored alphabetically
                    dt = _PT_DTYPE[pt]
                    row = np.frombuffer(
                        data, dt, w, off).astype(np.float64)
                    planes[name][y - ymin + r] = row
                    off += w * dt.itemsize
    names = [n for n, _ in chans]
    if all(k in names for k in "RGB"):
        return np.stack([planes["R"], planes["G"], planes["B"]], -1)
    if len(names) == 1:
        return planes[names[0]]
    return np.stack([planes[n] for n in sorted(names)], -1)


def _attr(name, typ, data):
    return (name.encode() + b"\x00" + typ.encode() + b"\x00"
            + struct.pack("<i", len(data)) + data)


def save_exr(path, img, compression=3):
    """Write (H, W, 3) or (H, W) float data as FLOAT channels.

    compression: 0 = NONE, 2 = ZIPS, 3 = ZIP (default)."""
    img = np.asarray(img, np.float32)
    gray = img.ndim == 2
    h, w = img.shape[:2]
    names = ["Y"] if gray else ["B", "G", "R"]  # alphabetical on disk
    chlist = b""
    for n in names:
        chlist += (n.encode() + b"\x00" + struct.pack("<i", PT_FLOAT)
                   + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1))
    chlist += b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr("channels", "chlist", chlist),
        _attr("compression", "compression", bytes([compression])),
        _attr("dataWindow", "box2i", box),
        _attr("displayWindow", "box2i", box),
        _attr("lineOrder", "lineOrder", b"\x00"),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\x00",
    ])
    lines_per = _COMP_LINES[compression]
    n_chunks = (h + lines_per - 1) // lines_per

    chunks = []
    for ci in range(n_chunks):
        y0 = ci * lines_per
        rows = min(lines_per, h - y0)
        raw = b""
        for r in range(rows):
            if gray:
                raw += img[y0 + r].astype("<f4").tobytes()
            else:
                for n in names:
                    c = {"R": 0, "G": 1, "B": 2}[n]
                    raw += img[y0 + r, :, c].astype("<f4").tobytes()
        if compression:
            comp = zlib.compress(_zip_filter(raw))
            data = comp if len(comp) < len(raw) else raw
        else:
            data = raw
        chunks.append((y0, data))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        f.write(header)
        base = 8 + len(header) + 8 * n_chunks
        off = base
        for y0, data in chunks:
            f.write(struct.pack("<Q", off))
            off += 8 + len(data)
        for y0, data in chunks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)
