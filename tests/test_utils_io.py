import numpy as np
import pytest

from nrc_hpm.utils.png import read_png, write_png
from nrc_hpm.utils.exr import read_radiance_hdr


def test_png_roundtrip_rgb(tmp_path):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (23, 31, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    assert np.array_equal(read_png(p), img)


def test_png_roundtrip_rgba_and_gray(tmp_path):
    rs = np.random.RandomState(1)
    for c in (1, 4):
        img = rs.randint(0, 256, (9, 7, c), dtype=np.uint8)
        p = str(tmp_path / f"c{c}.png")
        write_png(p, img)
        assert np.array_equal(read_png(p), img)


def test_png_float_input(tmp_path):
    img = np.linspace(0, 1, 12).reshape(3, 4).astype(np.float32)
    p = str(tmp_path / "f.png")
    write_png(p, img)
    back = read_png(p)
    assert back.shape == (3, 4, 1)
    assert abs(int(back[2, 3, 0]) - 255) <= 1


def test_png_bad_magic(tmp_path):
    p = tmp_path / "bad.png"
    p.write_bytes(b"nope" * 10)
    with pytest.raises(ValueError):
        read_png(str(p))


def test_hdr_reader_flat(tmp_path):
    w, h = 4, 2
    hdr = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
           + f"-Y {h} +X {w}\n".encode())
    vals = [(128, 64, 32, 129), (255, 255, 255, 128),
            (1, 2, 3, 130), (0, 0, 0, 0)] * 2
    body = bytes(b for px in vals for b in px)
    p = str(tmp_path / "t.hdr")
    open(p, "wb").write(hdr + body)
    img = read_radiance_hdr(p)
    assert img.shape == (2, 4, 3)
    # e=129 -> scale 2^(129-136) = 1/128: (128,64,32) -> (1.0, 0.5, 0.25)
    assert np.allclose(img[0, 0], [1.0, 0.5, 0.25])
    # zero exponent -> black
    assert np.allclose(img[0, 3], 0.0)


def test_camera_controllers():
    from nrc_hpm.camera import (Camera, camera_move, camera_rotate,
                                    camera_rotate_around_origin)
    cam = Camera.reference_camera()
    cam2, (p, v) = camera_move(cam, (64, 0, 0), (-1, 0, 0), (0.5, 0.2, 1.0))
    assert np.allclose(p, [63.0, 0.2, -0.5], atol=1e-5)
    cam3, (p3, v3) = camera_rotate(cam2, p, v, 0.3, 0.1)
    assert abs(np.linalg.norm(v3) - 1.0) < 1e-5
    cam4, (p4, v4) = camera_rotate_around_origin(cam3, p3, (0, 1, 0), 0.5)
    # orbit preserves distance to origin and looks at it
    assert abs(np.linalg.norm(p4) - np.linalg.norm(p3)) < 1e-3
    assert np.dot(v4, -p4 / np.linalg.norm(p4)) > 0.999


def test_checkpoint_roundtrip(tmp_path):
    import jax
    from nrc_hpm.config import AppConfig, EncodingConfig
    from nrc_hpm.models.nrc.cache import NeuralRadianceCache
    from nrc_hpm.utils.checkpoint import load_pytree, save_pytree
    cfg = AppConfig(nn_width=16, nn_depth=2,
                    encoding=EncodingConfig(n_levels=2, log2_hashmap_size=10))
    cache = NeuralRadianceCache(cfg)
    state = cache.init_state(jax.random.PRNGKey(0))
    p = str(tmp_path / "ck.npz")
    save_pytree(p, state)
    fresh = cache.init_state(jax.random.PRNGKey(1))
    loaded = load_pytree(p, fresh)
    a = np.asarray(state.params["mlp"]["layers"][0])
    b = np.asarray(loaded.params["mlp"]["layers"][0])
    assert np.array_equal(a, b)


def test_dynamic_scene_update():
    import dataclasses
    from nrc_hpm.config import SceneConfig
    from nrc_hpm.lights import lights_from_scene, update_scene
    # only scene 3 animates in the reference (HpmScene.cpp:64-71)
    scene = dataclasses.replace(SceneConfig.preset(3), dynamic=True)
    lights = lights_from_scene(scene)
    d0 = np.asarray(lights.dir_light.direction)
    l2 = update_scene(lights, scene, 0.5)
    d1 = np.asarray(l2.dir_light.direction)
    assert not np.allclose(d0, d1)
    assert abs(np.linalg.norm(d1) - 1.0) < 1e-5
    # static scenes unchanged
    static = SceneConfig.preset(3)
    l3 = update_scene(lights, static, 0.5)
    assert np.allclose(np.asarray(l3.dir_light.direction), d0)


def test_reset_accumulation():
    import jax.numpy as jnp
    from nrc_hpm.renderer import McRenderer, reset_accumulation
    from nrc_hpm.config import AppConfig, SceneConfig
    from nrc_hpm.camera import Camera
    from nrc_hpm.volume import seeded_volume
    cfg = AppConfig(scene=SceneConfig.preset(4), render_width=32,
                    render_height=16, mc_path_length=2)
    r = McRenderer(cfg, vol=seeded_volume(cfg.scene))
    cam = Camera.reference_camera(aspect=2.0)
    st = r.step(r.init_state(0), cam)
    assert float(jnp.abs(st.image).sum()) > 0
    st2 = reset_accumulation(st)
    assert float(jnp.abs(st2.image).sum()) == 0.0
    assert int(st2.blend_index) == 1


def test_checkpoint_rejects_structure_mismatch(tmp_path):
    """Same-shaped leaves under a different pytree structure must be
    rejected, not silently misassigned (e.g. optimizer config changed
    between save and load)."""
    import jax.numpy as jnp
    import pytest

    from nrc_hpm.utils.checkpoint import load_pytree, save_pytree
    p = str(tmp_path / "ck.npz")
    a = {"x": jnp.zeros((3,)), "y": jnp.ones((3,))}
    save_pytree(p, a)
    b = {"x": jnp.zeros((3,)), "z": jnp.ones((3,))}  # same shapes, new key
    with pytest.raises(ValueError, match="different pytree structure"):
        load_pytree(p, b)
