"""Image IO and tonemapping (``yhair_tpu/io/image.py``).

sRGB encode/decode, the exposure and filmic tonemap, HDR files (PFM,
Radiance RGBE, OpenEXR through ``io/exr.py``, ``.npy``) and a bilinear
resize, in numpy. PNG is this module's own codec, built from ``zlib``
and ``struct``: it needs no imaging library, which the card's machine
does not have. It writes 8-bit gray, RGB or RGBA, non-interlaced, with
row filter 0, and reads the same formats with any of the five row
filters. JPEG goes through PIL, imported when a JPEG is read or written.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for 8-bit samples
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def srgb_encode(x):
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * x ** (1.0 / 2.4) - 0.055)


def srgb_decode(x):
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def tonemap(hdr, exposure=0.0, filmic=False, srgb=True):
    """Exposure scale, optional filmic curve, sRGB."""
    x = np.asarray(hdr, np.float64) * (2.0 ** exposure)
    if filmic:
        # ACES filmic fit (Narkowicz)
        x *= 0.6
        x = (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14)
    x = np.clip(x, 0.0, 1.0)
    return srgb_encode(x) if srgb else x


def to_ldr(img, exposure=0.0, filmic=False):
    """The 8-bit image a PNG or JPEG of ``img`` holds."""
    return (tonemap(img, exposure, filmic) * 255 + 0.5).astype(np.uint8)


def _png_chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(ldr):
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes."""
    ldr = np.ascontiguousarray(ldr, np.uint8)
    if ldr.ndim == 2:
        ldr = ldr[..., None]
    h, w, c = ldr.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"PNG takes 1, 3 or 4 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           ldr.reshape(h, w * c)], axis=1)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype, row, prior, bpp):
    """One scanline's bytes (numpy uint8) with its filter undone."""
    if ftype == 0:
        return row
    if ftype == 2:
        return row + prior        # uint8 arithmetic wraps mod 256
    if ftype == 1:
        # Sub: a running sum per channel, mod 256
        px = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if ftype not in (3, 4):
        raise ValueError(f"PNG row filter {ftype} unknown")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, b, c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data):
    """PNG bytes -> (H, W) or (H, W, C) uint8 (8-bit gray, RGB or RGBA,
    non-interlaced)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}: only 8-bit gray, RGB and "
                         "RGBA without interlace are read")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.empty((h, w * c), np.uint8)
    prior = np.zeros(w * c, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, c)
    out = out.reshape(h, w, c)
    return out[..., 0] if c == 1 else out


def save_png(path, img, exposure=0.0, filmic=False):
    with open(path, "wb") as f:
        f.write(encode_png(to_ldr(img, exposure, filmic)))


def load_png(path, to_linear=True):
    with open(path, "rb") as f:
        arr = decode_png(f.read()).astype(np.float64) / 255.0
    return srgb_decode(arr) if to_linear else arr


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("JPEG files need PIL (the Pillow package); "
                          "PNG, PFM, EXR and HDR do not") from e
    return Image


def save_jpg(path, img, exposure=0.0, filmic=False, quality=92):
    """Tonemapped JPEG through PIL."""
    _pil_image().fromarray(to_ldr(img, exposure, filmic)).save(
        path, quality=quality)


def load_jpg(path, to_linear=True):
    arr = np.asarray(_pil_image().open(path), np.float64) / 255.0
    return srgb_decode(arr) if to_linear else arr


def save_pfm(path, img):
    """PFM: 'PF' header, W H, negative scale = little endian, bottom row
    first."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n-1.0\n".encode())
        f.write(np.flipud(img).astype("<f4").tobytes())


def load_pfm(path):
    with open(path, "rb") as f:
        magic = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3) if magic == b"PF" else data.reshape(h, w)
    return np.flipud(img).astype(np.float64)


def _float_to_rgbe(img):
    """(H, W, 3) float -> (H, W, 4) uint8 RGBE (shared exponent)."""
    img = np.maximum(np.asarray(img, np.float64), 0.0)
    maxc = img.max(axis=-1)
    rgbe = np.zeros(img.shape[:2] + (4,), np.uint8)
    valid = maxc >= 1e-32
    # frexp: maxc = m * 2^e with m in [0.5, 1)
    m, e = np.frexp(np.where(valid, maxc, 1.0))
    scale = m * 256.0 / np.where(valid, maxc, 1.0)
    rgbe[..., :3] = np.where(valid[..., None],
                             np.minimum(img * scale[..., None], 255.0),
                             0.0).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, e + 128, 0).astype(np.uint8)
    return rgbe


def _rgbe_to_float(rgbe):
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (rgbe[..., :3].astype(np.float64) + 0.5) * scale[..., None]


def save_radiance_hdr(path, img):
    """Radiance .hdr: RGBE in flat scanlines, which every .hdr reader
    takes."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(_float_to_rgbe(img).tobytes())


def load_radiance_hdr(path):
    """Reads flat and new-style RLE scanlines."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance HDR file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    out = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        # new-style RLE scanline marker: 0x02 0x02 then 16-bit width
        if (8 <= w < 32768 and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = data[pos]
                    pos += 1
                    if n > 128:           # run
                        out[y, x:x + n - 128, c] = data[pos]
                        x += n - 128
                        pos += 1
                    else:                 # literal
                        out[y, x:x + n, c] = np.frombuffer(
                            data, np.uint8, n, pos)
                        x += n
                        pos += n
        else:                             # flat scanline
            out[y] = np.frombuffer(data, np.uint8, w * 4,
                                   pos).reshape(w, 4)
            pos += w * 4
    return _rgbe_to_float(out)


def save_hdr(path, img):
    """By suffix: .pfm, .exr, .hdr (Radiance RGBE), else .npy."""
    p = str(path)
    if p.endswith(".pfm"):
        save_pfm(path, img)
    elif p.endswith(".exr"):
        from .exr import save_exr
        save_exr(path, img)
    elif p.endswith(".hdr"):
        save_radiance_hdr(path, img)
    else:
        np.save(path, np.asarray(img, np.float32))


def load_hdr(path):
    p = str(path)
    if p.endswith(".pfm"):
        return load_pfm(path)
    if p.endswith(".exr"):
        from .exr import load_exr
        return load_exr(path)
    if p.endswith(".hdr"):
        return load_radiance_hdr(path)
    return np.load(path).astype(np.float64)


def save_image(path, img, exposure=0.0, filmic=False):
    """By suffix: .png and .jpg/.jpeg tonemapped, anything else as HDR
    (``save_hdr``)."""
    p = str(path).lower()
    if p.endswith(".png"):
        save_png(path, img, exposure, filmic)
    elif p.endswith((".jpg", ".jpeg")):
        save_jpg(path, img, exposure, filmic)
    else:
        save_hdr(path, img)


def resize(img, height, width):
    """Bilinear resize of an HDR (H, W, C) / (H, W) image."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    ys = (np.arange(height) + 0.5) * h / height - 0.5
    xs = (np.arange(width) + 0.5) * w / width - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy
