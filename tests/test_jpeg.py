"""Native baseline JPEG codec vs PIL/libjpeg (independent implementation
parity in both directions)."""
import numpy as np
import pytest

from mitsuba_jax.io.jpeg import read_jpeg, write_jpeg

PIL = pytest.importorskip("PIL.Image")


def _test_image():
    rng = np.random.default_rng(0)
    h, w = 29, 37                       # non-multiple-of-8 on purpose
    xx, yy = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
    img = (np.stack([xx * 0.8 + 0.1, yy * 0.7 + 0.1, xx * yy * 0.9], -1)
           * 255).astype(np.uint8)
    return np.clip(img.astype(int) + rng.integers(-8, 8, img.shape),
                   0, 255).astype(np.uint8)


@pytest.mark.parametrize("subsampling", [2, 1, 0])  # 4:2:0, 4:2:2, 4:4:4
def test_decode_matches_libjpeg(tmp_path, subsampling):
    img = _test_image()
    p = str(tmp_path / "t.jpg")
    PIL.fromarray(img).save(p, quality=90, subsampling=subsampling)
    ours = read_jpeg(p)
    ref = np.asarray(PIL.open(p))
    # float IDCT vs libjpeg integer IDCT: spec allows small deltas
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 2


def test_decode_restart_markers_and_grayscale(tmp_path):
    img = _test_image()
    p = str(tmp_path / "t.jpg")
    PIL.fromarray(img).save(p, quality=85, restart_marker_rows=1)
    ours = read_jpeg(p)
    ref = np.asarray(PIL.open(p))
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 2
    PIL.fromarray(img[:, :, 0]).save(p, quality=90)
    ours = read_jpeg(p)
    ref = np.asarray(PIL.open(p))
    assert ours.ndim == 2
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 2


def test_encode_decodable_by_libjpeg(tmp_path):
    img = _test_image()
    p = str(tmp_path / "e.jpg")
    write_jpeg(p, img, quality=92)
    dec = np.asarray(PIL.open(p))
    err = np.abs(dec.astype(int) - img.astype(int))
    assert err.mean() < 6               # lossy, q92 on noisy content
    # and by our own decoder, consistently
    dec2 = read_jpeg(p)
    assert np.abs(dec2.astype(int) - dec.astype(int)).max() <= 2


def test_dispatch_via_read_write_image(tmp_path):
    from mitsuba_jax.io.bitmap import read_image, write_image

    img = _test_image()
    p = str(tmp_path / "d.jpg")
    write_image(p, img)
    out = read_image(p)
    assert out.shape == img.shape
    assert np.abs(out.astype(int) - img.astype(int)).mean() < 6
