"""mtsutil tool launcher (reference src/mitsuba/mtsutil.cpp:365)."""
import os

import numpy as np
import pytest

from mitsuba_jax.io.bitmap import read_image, write_image, write_mfilm
from mitsuba_jax.mtsutil import main


def test_unknown_tool():
    assert main(["nope"]) == 2


def test_help():
    assert main([]) == 0


def test_tonemap_roundtrip(tmp_path):
    src = str(tmp_path / "in.pfm")
    dst = str(tmp_path / "out.png")
    img = np.linspace(0, 2, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    write_image(src, img)
    assert main(["tonemap", src, dst, "-e", "0"]) == 0
    out = np.asarray(read_image(dst), np.float32)
    if out.max() > 2.0:   # PNG readers may return uint8
        out = out / 255.0
    assert out.shape == (8, 8, 3)
    assert out.max() <= 1.0 + 1e-6
    # tonemap is monotone: brightest input stays brightest
    assert out[7, 7, 2] >= out[0, 0, 0]


def test_addimages(tmp_path):
    a = str(tmp_path / "a.pfm")
    b = str(tmp_path / "b.pfm")
    o = str(tmp_path / "o.pfm")
    ia = np.full((4, 4, 3), 0.25, np.float32)
    ib = np.full((4, 4, 3), 0.5, np.float32)
    write_image(a, ia)
    write_image(b, ib)
    assert main(["addimages", a, b, o, "--wa", "2", "--wb", "1"]) == 0
    np.testing.assert_allclose(read_image(o), 1.0, rtol=1e-6)


def test_info(tmp_path, capsys):
    scene = os.path.join(os.path.dirname(__file__), "..", "scenes",
                         "cornell.xml")
    assert main(["info", scene, "-D", "spp=4", "-D", "depth=3",
                 "-D", "width=16", "-D", "height=16"]) == 0
    out = capsys.readouterr().out
    assert "triangles" in out and "16x16" in out


def test_ttest_mfilm_match_and_differ(tmp_path):
    m = np.random.default_rng(0).uniform(0.4, 0.6, (6, 6, 3))
    v = np.full((6, 6, 3), 1e-2)
    fa = str(tmp_path / "a.m")
    fb = str(tmp_path / "b.m")
    fc = str(tmp_path / "c.m")
    write_mfilm(fa, m, v, np.full((6, 6), 64))
    write_mfilm(fb, m + 1e-4, v, np.full((6, 6), 64))
    write_mfilm(fc, m + 10.0, v, np.full((6, 6), 64))
    assert main(["ttest", fa, fb]) == 0      # statistically identical
    assert main(["ttest", fa, fc]) == 1      # grossly different
