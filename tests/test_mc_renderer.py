import numpy as np
import pytest

from nrc_hpm.camera import Camera
from nrc_hpm.config import AppConfig, SceneConfig
from nrc_hpm.reference import GoldenReference, compare_images
from nrc_hpm.renderer import McRenderer
from nrc_hpm.volume import Volume, seeded_volume


@pytest.fixture(scope="module")
def small_mc():
    cfg = AppConfig(scene=SceneConfig.preset(4), render_width=64,
                    render_height=36, mc_path_length=8)
    return McRenderer(cfg, vol=seeded_volume(cfg.scene))


def test_mc_frame_basics(small_mc):
    cam = Camera.reference_camera(aspect=64 / 36)
    img = np.asarray(small_mc.render(cam, frames=2))
    assert img.shape == (36, 64, 4)
    assert np.isfinite(img).all()
    assert (img[..., :3] >= 0).all()
    # border rays miss the cloud box -> constant env color 0.1 (scene 4)
    assert img[0, 0, 0] == pytest.approx(0.1, abs=1e-5)
    assert img[0, 0, 3] == 0.0
    # some pixels scatter
    assert (img[..., 3] > 0).mean() > 0.1


def test_mc_reproducible(small_mc):
    cam = Camera.reference_camera(aspect=64 / 36)
    a = np.asarray(small_mc.render(cam, frames=1, seed=5))
    b = np.asarray(small_mc.render(cam, frames=1, seed=5))
    c = np.asarray(small_mc.render(cam, frames=1, seed=6))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_mc_blend_is_running_mean(small_mc):
    """The temporal blend (blendFactor = 1/blendIndex,
    McHpmRenderer.cpp:124-136) must equal the running mean of the
    per-frame images.  Reconstruct each frame's fresh contribution from
    consecutive accumulations and check mean(frames) == accumulated."""
    cam = Camera.reference_camera(aspect=64 / 36)
    state = small_mc.init_state(3)
    frames = []
    prev = np.asarray(state.image)
    for i in range(3):
        state = small_mc.step(state, cam)
        cur = np.asarray(state.image)
        bf = 1.0 / (i + 1)  # blend factor used by this step
        frames.append((cur - (1.0 - bf) * prev) / bf)
        prev = cur
    assert int(state.blend_index) == 4
    np.testing.assert_allclose(np.mean(frames, axis=0), prev,
                               rtol=1e-4, atol=1e-5)


def test_mc_statistical_match_vs_golden(cloud_grid):
    """The headline oracle: a short CPU MC run of the WDAS cloud must land
    near the golden EXR's mean brightness (8192-frame, 64-bounce
    accumulation)."""
    cfg = AppConfig(scene=SceneConfig.preset(4), render_width=96,
                    render_height=54, mc_path_length=32)
    r = McRenderer(cfg, vol=Volume.from_dense(cloud_grid.data, 0.6, 0.8))
    cam = Camera.reference_camera(aspect=96 / 54)
    img = np.asarray(r.render(cam, frames=12, seed=1))
    res = GoldenReference.load(4).compare(img)
    # 12 frames of noise: demand the mean is within 6% of the golden
    assert abs(res.rel_bias) < 0.06, res


def test_compare_images_formulas():
    ref = np.zeros((4, 4, 4), np.float32)
    ref[..., :3] = 2.0
    ref[..., 3] = 1.0
    ref[0, 0, 3] = 0.0  # invalid pixel
    own = np.zeros((4, 4, 4), np.float32)
    own[..., :3] = 3.0
    res = compare_images(ref, own)
    assert res.valid_pixel_count == 15
    assert res.mse == pytest.approx(1.0)
    assert res.ref_mean == pytest.approx(2.0)
    assert res.own_mean == pytest.approx(3.0)
    assert res.own_var == pytest.approx(0.0)
    assert res.rel_bias == pytest.approx(0.5)
