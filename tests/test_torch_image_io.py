"""Image I/O of the port (utils/image_io.py, native.write_png) and the
asset paths that use it (environment.load_hdr_by_name, image textures and
hdr_path in scene files), against the reference's on generated files."""

import json

import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import sceneio as jio
from raytracer_project_tpu.utils import image_io as jimg
from raytracer_project_tpu_torch import native
from raytracer_project_tpu_torch.core import colorspace as tcs
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import sceneio as tio
from raytracer_project_tpu_torch.utils import image_io as timg

from test_torch_sceneio import _assert_same

torch.set_num_threads(2)


def _pixels(h=13, w=17, seed=0):
    return (np.random.default_rng(seed).random((h, w, 3)) * 256).astype(np.uint8)


@pytest.mark.parametrize("writer", ["native", "pure", "save_png"])
def test_png_round_trip(tmp_path, writer):
    """Each writer's file decodes to its pixels, with PIL and with the
    port's reader (PIL's adaptive scanline filters included)."""
    from PIL import Image

    px = _pixels()
    path = str(tmp_path / f"{writer}.png")
    if writer == "native":
        if not native.available():
            pytest.skip("the native library does not build here")
        assert native.write_png(path, px)
    elif writer == "pure":
        timg._save_png_pure(path, px)
    else:
        timg.save_png(path, tcs.to_srgb_u8(torch.as_tensor(px / 255.0)))
        px = tcs.to_srgb_u8(torch.as_tensor(px / 255.0)).numpy()
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), px)
    np.testing.assert_array_equal(timg.read_png(path), px)


def test_read_png_decodes_every_filter(tmp_path):
    """A smooth and a noisy image through PIL's encoder (which picks the
    scanline filters) read back exactly, and every filter type occurs."""
    from PIL import Image

    y, x = np.mgrid[0:40, 0:57]
    smooth = np.stack([x * 4, y * 6, (x + y) * 2], -1).astype(np.uint8)
    for px in (smooth, _pixels(31, 45, seed=4)):
        path = str(tmp_path / "f.png")
        Image.fromarray(px, "RGB").save(path, optimize=False)
        np.testing.assert_array_equal(timg.read_png(path), px)
    for ftype in range(5):
        raw = np.zeros((4, 1 + 3 * 5), np.uint8)
        raw[:, 0] = ftype
        raw[:, 1:] = _pixels(4, 5, seed=ftype).reshape(4, -1)
        path = str(tmp_path / f"f{ftype}.png")
        timg._save_png_pure(path, np.zeros((4, 5, 3), np.uint8))
        _rewrite_idat(path, raw)
        with Image.open(path) as im:
            np.testing.assert_array_equal(timg.read_png(path),
                                          np.asarray(im.convert("RGB")))


def _rewrite_idat(path, raw):
    """Replace the IDAT chunk of a PNG with the zlib stream of `raw`."""
    import struct
    import zlib

    data = open(path, "rb").read()
    i = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[i:i + 4])[0]
    body = zlib.compress(raw.tobytes())
    chunk = (struct.pack(">I", len(body)) + b"IDAT" + body
             + struct.pack(">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(data[:i] + chunk + data[i + 12 + n:])


def _hdr_image(h=6, w=9, seed=1):
    rng = np.random.default_rng(seed)
    img = rng.lognormal(0.0, 2.0, size=(h, w, 3)).astype(np.float32)
    img[0, 0] = 0.0
    return img


def _rle_radiance(img: np.ndarray) -> bytes:
    """A new-style run-length coded Radiance file of img (runs where a
    channel repeats, literals elsewhere), encoded like the reference's
    save_hdr quantizes."""
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    exp = np.where(maxc > 1e-32, np.frexp(maxc)[1], 0)
    scale = np.where(maxc > 1e-32, np.ldexp(1.0, -exp) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, exp + 128, 0)
    rgbe[:, 2:7, 3] = rgbe[:, 2:3, 3]        # a run in every scanline (the
                                             # image is not img's there)
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", f"-Y {h} +X {w}\n".encode()]
    for y in range(h):
        out.append(bytes([2, 2, w >> 8, w & 0xFF]))
        for ch in range(4):
            row = rgbe[y, :, ch]
            x = 0
            while x < w:
                run = 1
                while x + run < w and row[x + run] == row[x] and run < 127:
                    run += 1
                if run > 2:
                    out.append(bytes([128 + run, row[x]]))
                    x += run
                else:
                    out.append(bytes([1, row[x]]))
                    x += 1
    return b"".join(out)


@pytest.mark.parametrize("coding", ["flat", "rle"])
def test_radiance_parse_matches_reference(tmp_path, coding):
    img = _hdr_image()
    path = str(tmp_path / f"{coding}.hdr")
    if coding == "flat":
        timg.save_hdr(path, img)
    else:
        with open(path, "wb") as f:
            f.write(_rle_radiance(img))
    with open(path, "rb") as f:
        data = f.read()
    ref = jimg._parse_radiance(data)
    np.testing.assert_array_equal(timg._parse_radiance(data), ref)
    np.testing.assert_array_equal(timg.load_hdr(path), ref)
    if coding == "flat":
        # RGBE keeps 8 bits of each pixel's brightest channel.
        np.testing.assert_allclose(ref.max(-1), img.max(-1), rtol=2 ** -7)
    assert timg.load_hdr(str(tmp_path / "none.hdr")) is None


def test_load_hdr_by_name(tmp_path, monkeypatch):
    """Maps under $RAYTRACER_TPU_ASSETS/hdr_maps resolve by path, file name
    or stem; an unknown name gives the black 1x1 fallback."""
    d = tmp_path / "hdr_maps"
    d.mkdir()
    timg.save_hdr(str(d / "sky.hdr"), _hdr_image())
    timg.save_hdr(str(d / "dusk.hdr"), _hdr_image(seed=2))
    monkeypatch.setenv("RAYTRACER_TPU_ASSETS", str(tmp_path))
    assert tenv.refresh_hdr_list() == jenv.refresh_hdr_list()
    assert [p.rsplit("/", 1)[1] for p in tenv.refresh_hdr_list()] == [
        "dusk.hdr", "sky.hdr"]
    for name in ("sky", "sky.hdr", str(d / "dusk.hdr"), "nothing"):
        np.testing.assert_array_equal(tenv.load_hdr_by_name(name),
                                      jenv.load_hdr_by_name(name))
    assert tenv.load_hdr_by_name("nothing").shape == (1, 1, 3)


def test_scene_file_with_image_texture_and_hdr(tmp_path):
    """A scene document with a PNG image texture, an .hdr image texture and
    an hdr_path loads to the reference loader's tables."""
    timg._save_png_pure(str(tmp_path / "wood.png"), _pixels(8, 12))
    timg.save_hdr(str(tmp_path / "glow.hdr"), _hdr_image(4, 5))
    timg.save_hdr(str(tmp_path / "sky.hdr"), _hdr_image(16, 32, seed=3))
    doc = {
        "textures": {"wood": {"type": "image", "path": "wood.png"},
                     "glow": {"type": "image", "path": "glow.hdr"}},
        "materials": {"w": {"type": "lambertian", "texture": "wood"},
                      "g": {"type": "metal", "texture": "glow", "fuzz": 0.1}},
        "objects": [{"type": "sphere", "center": [0, 0, 0], "radius": 1.0,
                     "material": "w"},
                    {"type": "sphere", "center": [2, 0, 0], "radius": 0.5,
                     "material": "g"}],
        "environment": {"mode": "hdr", "hdr_path": "sky.hdr",
                        "hdri_rotation": 0.3},
    }
    path = str(tmp_path / "scene.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    got = tio.load_scene_file(path, with_bvh=False)
    _assert_same(jio.load_scene_file(path, with_bvh=False), got)
    assert got[0].textures.count == 2 and got[2].hdr_image.shape == (16, 32, 3)
    assert int(got[0].textures.kind[0]) == 0   # KIND_IMAGE


def test_asset_root_images(tmp_path, monkeypatch):
    """Bump maps and the wood texture come from $RAYTRACER_TPU_ASSETS when
    the files exist (the reference's asset layout), else from the
    procedural generators; both as the reference reads them."""
    from PIL import Image

    from raytracer_project_tpu.models import assets as jassets
    from raytracer_project_tpu_torch.models import assets as tassets

    (tmp_path / "bump_maps").mkdir()
    (tmp_path / "textures").mkdir()
    Image.fromarray(_pixels(16, 24, seed=5), "RGB").save(
        str(tmp_path / "bump_maps" / "wood_bump_map.jpg"), format="JPEG")
    Image.fromarray(_pixels(8, 8, seed=6), "RGB").save(
        str(tmp_path / "textures" / "fine-wood.jpg"), format="JPEG")
    names = ("wood_bump_map", "scratches_bump_map", "fine_wood_texture")

    def clear():
        for mod in (jassets, tassets):
            for name in names:
                getattr(mod, name).cache_clear()

    monkeypatch.setenv("RAYTRACER_TPU_ASSETS", str(tmp_path))
    clear()
    try:
        for name in names:
            got = getattr(tassets, name)()
            np.testing.assert_array_equal(got, getattr(jassets, name)())
        assert tassets.wood_bump_map().shape == (16, 24, 3)
        assert tassets.scratches_bump_map().shape == (256, 256, 3)
    finally:
        clear()
