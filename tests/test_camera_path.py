"""Camera-path playback (camera_path.py) vs the reference controller's
semantics (src/Input.cpp:49-97, src/Camera.cpp:176-199)."""
import json

import numpy as np

from nrc_hpm.camera import Camera, camera_move, camera_rotate
from nrc_hpm.camera_path import CameraPath


def _path(tmp_path, doc):
    p = tmp_path / "path.json"
    p.write_text(json.dumps(doc))
    return str(p)


def test_keys_move_matches_input_cpp_speed(tmp_path):
    # W held for 3 frames at 60 fps = 3 * 20/60 units forward
    path = CameraPath.load(_path(tmp_path, {
        "start": {"pos": [64, 0, 0], "view_dir": [-1, 0, 0]},
        "commands": [{"frame": 0, "keys": "W", "frames": 3}],
    }))
    pl = path.player(aspect=16 / 9)
    for f in range(4):
        cam, changed = pl.update(f)
        assert changed == (f < 3)
    # view_dir (-1,0,0): front = view projected to XZ = (-1,0,0)
    np.testing.assert_allclose(pl.pos, [64 - 3 * 20 / 60, 0, 0], atol=1e-5)


def test_shift_multiplies_speed_10x(tmp_path):
    pl = CameraPath.load(_path(tmp_path, {
        "start": {"pos": [0, 0, 0], "view_dir": [0, 0, 1]},
        "commands": [{"frame": 0, "keys": "W", "shift": True}],
    })).player(1.0)
    pl.update(0)
    np.testing.assert_allclose(pl.pos, [0, 0, 200 / 60], atol=1e-5)


def test_mouse_scaling_matches_reference(tmp_path):
    # Input.cpp:58 — mouseMove = 0.005 * -GetMouseMove() then
    # RotateViewDir(move.x, move.y)
    pl = CameraPath.load(_path(tmp_path, {
        "start": {"pos": [0, 0, 0], "view_dir": [0, 0, 1]},
        "commands": [{"frame": 0, "mouse": [10, 0]}],
    })).player(1.0)
    cam, changed = pl.update(0)
    assert changed
    want_cam, (_, want_view) = camera_rotate(
        Camera.create(np.zeros(3), np.array([0, 0, 1.0])),
        np.zeros(3), np.array([0, 0, 1.0]), -0.05, 0.0)
    np.testing.assert_allclose(pl.view, want_view, atol=1e-6)


def test_static_frames_report_unchanged(tmp_path):
    pl = CameraPath.load(_path(tmp_path, {
        "commands": [{"frame": 5, "move": [1, 0, 0]}],
    })).player(1.0)
    for f in range(5):
        _, changed = pl.update(f)
        assert not changed
    _, changed = pl.update(5)
    assert changed


def test_raw_move_uses_camera_frame(tmp_path):
    start_pos = np.array([1.0, 2.0, 3.0], np.float32)
    view = np.array([0.5, 0.0, 0.5], np.float32)
    pl = CameraPath.load(_path(tmp_path, {
        "start": {"pos": start_pos.tolist(), "view_dir": view.tolist()},
        "commands": [{"frame": 0, "move": [0.25, -0.5, 1.5]}],
    })).player(1.0)
    pl.update(0)
    vn = view / np.linalg.norm(view)
    _, (want_pos, _) = camera_move(
        Camera.create(start_pos, vn), start_pos, vn, [0.25, -0.5, 1.5])
    np.testing.assert_allclose(pl.pos, want_pos, atol=1e-5)
