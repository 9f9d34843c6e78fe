import numpy as np
import pytest

from nrc_hpm.utils.exr import read_exr_rgba, write_exr


def test_golden_image_loads():
    img = read_exr_rgba("/root/reference/reference/4/0.exr")
    assert img.shape == (1080, 1920, 4)
    assert np.isfinite(img).all()
    # scene 4: miss pixels show the constant env map at strength 0.1
    assert img[0, 0, 0] == pytest.approx(0.1, abs=1e-4)
    # alpha holds accumulated didScatter info
    assert 0.2 < (img[..., 3] > 0.5).mean() < 0.4


def test_all_checked_in_goldens_load():
    for scene in (0, 1, 2, 4, 5):
        img = read_exr_rgba(f"/root/reference/reference/{scene}/0.exr")
        assert img.shape == (1080, 1920, 4)
        assert np.isfinite(img).all()


def test_roundtrip_compressed(tmp_path):
    rnd = np.random.RandomState(0).rand(33, 65, 4).astype(np.float32)
    p = str(tmp_path / "x.exr")
    write_exr(p, rnd)
    assert np.allclose(read_exr_rgba(p), rnd)


def test_roundtrip_uncompressed_rgb(tmp_path):
    rnd = np.random.RandomState(1).rand(7, 5, 3).astype(np.float32)
    p = str(tmp_path / "y.exr")
    write_exr(p, rnd, compress=False)
    back = read_exr_rgba(p)
    assert np.allclose(back[..., :3], rnd)
    assert np.allclose(back[..., 3], 1.0)


def test_bad_magic(tmp_path):
    p = tmp_path / "z.exr"
    p.write_bytes(b"not an exr file padding padding")
    with pytest.raises(ValueError):
        read_exr_rgba(str(p))
