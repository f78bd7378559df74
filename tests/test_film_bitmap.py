"""Film reconstruction filters + bitmap I/O round trips."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mitsuba_jax.io import bitmap
from mitsuba_jax.render import rfilter as rf
from mitsuba_jax.render.film import develop, develop_with_variance


def test_filters_normalized_on_constant_field():
    """Any filter reconstructing a constant image must return the constant."""
    h = w = 8
    spp = 4
    key = jax.random.key(0)
    L = jnp.ones((h * w * spp, 3)) * 3.5
    offs = jax.random.uniform(key, (h * w * spp, 2))
    for name in ("box", "gaussian", "mitchell", "catmullrom", "tent", "wsinc"):
        img = develop(L, offs, spp, h, w, rf.make_rfilter(name))
        np.testing.assert_allclose(np.asarray(img), 3.5, atol=1e-4, err_msg=name)


def test_gaussian_filter_smooths_noise():
    h = w = 16
    spp = 1
    key = jax.random.key(1)
    L = jax.random.uniform(key, (h * w * spp, 3))
    offs = jnp.full((h * w * spp, 2), 0.5)
    box = np.asarray(develop(L, offs, spp, h, w, rf.make_box()))
    gauss = np.asarray(develop(L, offs, spp, h, w, rf.make_gaussian()))
    assert gauss.var() < box.var()


def test_develop_with_variance():
    h = w = 4
    spp = 8
    L = jax.random.normal(jax.random.key(2), (h * w * spp, 3)) + 5.0
    mean, var, n = develop_with_variance(L, spp, h, w)
    lv = np.asarray(L).reshape(h, w, spp, 3)
    np.testing.assert_allclose(np.asarray(mean), lv.mean(2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(var), lv.var(2, ddof=1), rtol=1e-4)
    assert int(n[0, 0]) == spp


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    for shape in [(7, 5, 3), (4, 9, 4), (6, 6, 1)]:
        img = rng.integers(0, 255, shape, dtype=np.uint8)
        p = str(tmp_path / f"t{shape[2]}.png")
        bitmap.write_png(p, img)
        back = bitmap.read_png(p)
        np.testing.assert_array_equal(back, img)


def test_png_16bit(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 65535, (5, 4, 3), dtype=np.uint16)
    p = str(tmp_path / "t16.png")
    bitmap.write_png(p, img)
    np.testing.assert_array_equal(bitmap.read_png(p), img)


def test_png_readable_by_pil(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    p = str(tmp_path / "x.png")
    bitmap.write_png(p, img)
    np.testing.assert_array_equal(np.asarray(PIL.open(p)), img)


def test_pfm_roundtrip(tmp_path):
    img = np.random.default_rng(2).normal(size=(6, 8, 3)).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    bitmap.write_pfm(p, img)
    np.testing.assert_array_equal(bitmap.read_pfm(p), img)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("half", [False, True])
def test_exr_roundtrip(tmp_path, compress, half):
    img = np.abs(np.random.default_rng(3).normal(size=(9, 7, 3))).astype(np.float32) * 10
    p = str(tmp_path / "t.exr")
    bitmap.write_exr(p, img, half=half, compress=compress)
    back = bitmap.read_exr(p)
    tol = 3e-2 if half else 1e-6
    np.testing.assert_allclose(back, img, rtol=tol, atol=tol)


def test_ppm_roundtrip(tmp_path):
    img = np.random.default_rng(4).integers(0, 255, (5, 5, 3), dtype=np.uint8)
    p = str(tmp_path / "t.ppm")
    bitmap.write_ppm(p, img)
    np.testing.assert_array_equal(bitmap.read_ppm(p), img)


def test_mfilm_roundtrip(tmp_path):
    mean = np.random.default_rng(5).uniform(size=(3, 4, 3)).astype(np.float32)
    var = np.random.default_rng(6).uniform(size=(3, 4, 3)).astype(np.float32)
    p = str(tmp_path / "t.m")
    bitmap.write_mfilm(p, mean, var, np.full((3, 4), 16))
    back = bitmap.read_mfilm(p)
    np.testing.assert_allclose(back["pixels"], mean, rtol=1e-5)
    np.testing.assert_allclose(back["variance"], var, rtol=1e-5)


def test_tga_roundtrip(tmp_path):
    img = np.random.default_rng(7).integers(0, 255, (6, 5, 3), dtype=np.uint8)
    p = str(tmp_path / "t.tga")
    bitmap.write_tga(p, img)
    np.testing.assert_array_equal(bitmap.read_tga(p), img)
    # 4-channel and grayscale
    rgba = np.random.default_rng(8).integers(0, 255, (4, 3, 4), dtype=np.uint8)
    bitmap.write_tga(p, rgba)
    np.testing.assert_array_equal(bitmap.read_tga(p), rgba)
    gray = np.random.default_rng(9).integers(0, 255, (4, 3), dtype=np.uint8)
    bitmap.write_tga(p, gray)
    np.testing.assert_array_equal(bitmap.read_tga(p), gray)


def test_tga_rle_and_pil_parity(tmp_path):
    # hand-build an RLE (type 10) bottom-origin TGA: 2x2 RGB
    # pixels (BGR in file): run of 2x (1,2,3) then raw 2 pixels
    px = bytes([3, 2, 1])                       # BGR for RGB(1,2,3)
    raw = bytes([30, 20, 10, 60, 50, 40])       # RGB(10,20,30), (40,50,60)
    hdr = bytearray(18)
    hdr[2] = 10
    hdr[12:14] = (2).to_bytes(2, "little")
    hdr[14:16] = (2).to_bytes(2, "little")
    hdr[16] = 24                                # bottom-left origin
    p = str(tmp_path / "rle.tga")
    with open(p, "wb") as f:
        f.write(bytes(hdr))
        f.write(bytes([0x81]) + px)             # run packet, count 2
        f.write(bytes([0x01]) + raw)            # raw packet, count 2
    img = bitmap.read_tga(p)
    # bottom row first in file -> flipped to top-origin on read
    np.testing.assert_array_equal(img[1], [[1, 2, 3], [1, 2, 3]])
    np.testing.assert_array_equal(img[0], [[10, 20, 30], [40, 50, 60]])
    try:
        from PIL import Image
    except ImportError:
        return
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)


def test_bmp_roundtrip_and_pil_parity(tmp_path):
    img = np.random.default_rng(10).integers(0, 255, (5, 7, 3),
                                             dtype=np.uint8)
    p = str(tmp_path / "t.bmp")
    bitmap.write_bmp(p, img)
    np.testing.assert_array_equal(bitmap.read_bmp(p), img)
    try:
        from PIL import Image
    except ImportError:
        return
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")),
                                  img)
    # read a PIL-written BMP (independent encoder)
    p2 = str(tmp_path / "pil.bmp")
    Image.fromarray(img).save(p2)
    np.testing.assert_array_equal(bitmap.read_bmp(p2), img)
