import numpy as np

from nrc_hpm.camera import Camera, look_at, perspective, pixel_rays


def test_perspective_matches_glm():
    # glm::perspectiveRH_NO(radians(60), 16/9, 0.1, 100)
    m = perspective(np.radians(60.0), 16 / 9, 0.1, 100.0)
    t = np.tan(np.radians(30.0))
    assert np.isclose(m[0, 0], 1 / ((16 / 9) * t))
    assert np.isclose(m[1, 1], 1 / t)
    assert np.isclose(m[2, 2], -(100.1) / 99.9)
    assert np.isclose(m[2, 3], -(2 * 100 * 0.1) / 99.9)
    assert m[3, 2] == -1.0


def test_look_at_properties():
    eye = np.array([64.0, 0.0, 0.0])
    v = look_at(eye, eye + np.array([-1.0, 0.0, 0.0]), np.array([0.0, 1, 0.0]))
    # eye maps to origin
    assert np.allclose(v @ np.array([64, 0, 0, 1.0]), [0, 0, 0, 1], atol=1e-5)
    # a point ahead of the camera maps to -Z (right-handed view space)
    p = v @ np.array([0.0, 0, 0, 1.0])
    assert p[2] < 0 and abs(p[0]) < 1e-5 and abs(p[1]) < 1e-5


def test_center_ray_is_view_dir():
    cam = Camera.reference_camera()
    _, rd, _ = pixel_rays(cam, 64, 36)
    center = np.asarray(rd)[18, 32]
    # near-center pixel looks almost exactly along (-1, 0, 0)
    assert center[0] < -0.999


def test_ray_field_of_view():
    cam = Camera.reference_camera(aspect=1.0)
    _, rd, _ = pixel_rays(cam, 65, 65)
    rd = np.asarray(rd)
    top = rd[0, 32]
    bottom = rd[64, 32]
    # vertical fov 60 deg -> half-angle 30 deg between center and edge
    ang = np.degrees(np.arccos(np.dot(top, bottom)))
    assert 55 < ang < 61


def test_rays_unit_norm():
    cam = Camera.create((3.0, 4.0, 5.0), (0.2, -0.4, 0.3))
    _, rd, uv = pixel_rays(cam, 16, 9)
    assert np.allclose(np.linalg.norm(np.asarray(rd), axis=-1), 1.0, atol=1e-5)
    assert uv.shape == (9, 16, 2)
    assert np.asarray(uv)[0, 0, 0] == 0.0
