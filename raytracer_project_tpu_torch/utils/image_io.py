"""Image I/O (twin of raytracer_project_tpu/utils/image_io.py): PNG save,
LDR image load, Radiance .hdr load and save, in numpy on the host.

These take the places of the reference engine's stb_image and
stb_image_write (texture.hpp:23-31, camera.hpp:779, environment.hpp:46-69).
PIL is optional: without it PNGs are written by the native library's
writer (native.write_png) or, failing that, by the pure-Python encoder
below, and LDR images do not load.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def save_png(path: str, pixels_u8) -> None:
    """Write an 8-bit RGB PNG from uint8 [H, W, 3] (a numpy array or a
    tensor on any device). Writers in order: PIL, the native library, the
    pure-Python encoder; each writes a valid PNG."""
    if hasattr(pixels_u8, "detach"):
        pixels_u8 = pixels_u8.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(pixels_u8, np.uint8))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        from PIL import Image

        Image.fromarray(arr, "RGB").save(path)
        return
    except ImportError:
        pass
    from .. import native

    if native.write_png(path, arr):
        return
    _save_png_pure(path, arr)


def _save_png_pure(path: str, arr: np.ndarray) -> None:
    """Dependency-free PNG encoder (filter 0 and zlib)."""
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W, 3] of an 8-bit RGB PNG without interlace, as the three
    writers above write them (every scanline filter, 0-4, decoded)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError("only 8-bit RGB PNGs without interlace")
        elif tag == b"IDAT":
            idat += body
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.uint8)
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        ftype, line = int(raw[y, 0]), raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(w, 3), axis=0).reshape(-1)
        elif ftype == 2:    # Up
            cur = line + prev
        elif ftype in (3, 4):   # Average, Paeth: each byte needs its left one
            cur = np.zeros(3 * w, np.int32)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - 3] if x >= 3 else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter {ftype}")
        prev = cur & 0xFF
        out[y] = prev
    return out.reshape(h, w, 3)


def load_image(path: str) -> np.ndarray | None:
    """An LDR image as f32 [H, W, 3] in [0, 1] (u8 / 255,
    texture.hpp:71-74); None when it cannot be read (PIL missing, or a bad
    file): the caller shows the cyan sentinel (texture.hpp:52-54)."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.float32) / 255.0
    except Exception:
        return None


def load_hdr(path: str) -> np.ndarray | None:
    """A Radiance RGBE (.hdr) image as linear f32 [H, W, 3]; None when it
    cannot be read (environment.hpp:64-68 falls back to black)."""
    try:
        with open(path, "rb") as f:
            return _parse_radiance(f.read())
    except (OSError, ValueError, IndexError):
        return None


def _parse_radiance(data: bytes) -> np.ndarray:
    """Decode a Radiance file: flat or new-style RLE scanlines, -Y h +X w."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance file")
    # The header ends at the first blank line; the next one is the size.
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported orientation {dims!r}")
    h, w = int(dims[1]), int(dims[3])
    pos = eol + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = memoryview(data)
    for y in range(h):
        if buf[pos] == 2 and buf[pos + 1] == 2:
            # New-style RLE: 0x02 0x02, the 16-bit width, then each channel
            # as runs (count > 128) and literals.
            if ((buf[pos + 2] << 8) | buf[pos + 3]) != w:
                raise ValueError("scanline width mismatch")
            pos += 4
            for ch in range(4):
                x = 0
                while x < w:
                    count = buf[pos]
                    pos += 1
                    if count > 128:
                        rgbe[y, x:x + count - 128, ch] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:
                        rgbe[y, x:x + count, ch] = np.frombuffer(
                            buf[pos:pos + count], np.uint8)
                        pos += count
                        x += count
        else:
            rgbe[y] = np.frombuffer(buf[pos:pos + w * 4], np.uint8).reshape(w, 4)
            pos += w * 4
    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(exponent > 0, np.ldexp(1.0, exponent - 136), 0.0)
    return (mantissa + 0.5) * scale.astype(np.float32)[..., None] * np.where(
        exponent[..., None] > 0, 1.0, 0.0)


def save_hdr(path: str, img) -> None:
    """Write f32 [H, W, 3] as a flat (not run-length coded) Radiance file."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    nz = maxc > 1e-32
    exp[nz] = np.frexp(maxc[nz])[1]
    scale = np.zeros((h, w), np.float32)
    scale[nz] = np.ldexp(1.0, -exp[nz]) * 256.0
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
