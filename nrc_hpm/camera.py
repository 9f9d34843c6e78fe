"""Pinhole camera with glm-compatible matrices.

Replicates the reference camera (src/Camera.cpp:164-174): projection =
glm::perspective (right-handed, [-1,1] clip depth — the reference never
defines GLM_FORCE_DEPTH_ZERO_TO_ONE), view = glm::lookAt, and per-pixel
unprojection exactly as nrc/gen_rays.comp:60-63 / mc/render.comp:49-52:

    screen = (uv*2-1, 0, 1);  world = invProjView @ screen
    rd = normalize(world.xyz/world.w - cam.pos)

Known reference quirk (documented, not replicated): Camera.cpp:168 stores the
bare projection matrix into ``prevProjView``; only the dead ReSTIR shaders
would have consumed it, so we simply do not carry a prevProjView.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .utils import pytree


def perspective(fovy: float, aspect: float, near: float, far: float
                ) -> np.ndarray:
    """glm::perspectiveRH_NO as a row-major matrix acting on column vectors."""
    t = np.tan(0.5 * fovy)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAtRH as a row-major matrix."""
    eye = np.asarray(eye, np.float32)
    f = np.asarray(center, np.float32) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


@pytree.dataclass
class Camera:
    """Device-side camera state (a pytree of two leaves)."""

    pos: jax.Array           # (3,)
    inv_proj_view: jax.Array  # (4, 4)

    @staticmethod
    def create(pos, view_dir, up=(0.0, 1.0, 0.0), aspect=16.0 / 9.0,
               fovy=np.radians(60.0), near=0.1, far=100.0) -> "Camera":
        """Matches the main-loop camera (main.cu:180-187): pos=(64,0,0),
        dir=(-1,0,0), up=+Y, fov 60 deg, near 0.1, far 100."""
        pos = np.asarray(pos, np.float32)
        view_dir = np.asarray(view_dir, np.float32)
        proj = perspective(float(fovy), float(aspect), float(near), float(far))
        view = look_at(pos, pos + view_dir, np.asarray(up, np.float32))
        proj_view = proj @ view
        inv = np.linalg.inv(proj_view).astype(np.float32)
        return Camera(pos=jnp.asarray(pos), inv_proj_view=jnp.asarray(inv))

    @staticmethod
    def reference_camera(aspect=16.0 / 9.0) -> "Camera":
        """The fixed golden-image camera (Reference.cpp:443-455) — identical
        to the default main camera."""
        return Camera.create((64.0, 0.0, 0.0), (-1.0, 0.0, 0.0), aspect=aspect)


def pixel_rays(cam: Camera, width: int, height: int):
    """Generate per-pixel (origin, dir) exactly like gen_rays.comp:55-72.

    Returns (ro (3,), rd (H, W, 3), frag_uv (H, W, 2)).
    frag_uv = (x/W, y/H) with x the fast axis — also the RNG seed UV.
    """
    x = jnp.arange(width, dtype=jnp.float32)
    y = jnp.arange(height, dtype=jnp.float32)
    u = x * (1.0 / width)
    v = y * (1.0 / height)
    uu, vv = jnp.meshgrid(u, v, indexing="xy")  # (H, W)
    frag_uv = jnp.stack([uu, vv], axis=-1)
    return cam.pos, rays_for_uv(cam, frag_uv), frag_uv


def rays_for_uv(cam: Camera, frag_uv: jax.Array) -> jax.Array:
    """Unproject arbitrary (..., 2) UVs to world-space unit directions."""
    sc = frag_uv * 2.0 - 1.0
    screen = jnp.stack(
        [sc[..., 0], sc[..., 1],
         jnp.zeros_like(sc[..., 0]), jnp.ones_like(sc[..., 0])], axis=-1)
    # full f32 precision: a reduced-precision (bf16/TF32) matmul rounds the
    # unproject enough to collapse near-center rays onto the camera position
    world = jnp.matmul(screen, cam.inv_proj_view.T, precision="highest")
    pixel_world = world[..., :3] / world[..., 3:4]
    rd = pixel_world - cam.pos
    norm = jnp.linalg.norm(rd, axis=-1, keepdims=True)
    return rd / jnp.maximum(norm, 1e-20)


def camera_move(cam: Camera, pos, view_dir, move, up=(0.0, 1.0, 0.0)):
    """WASD-style move (src/Camera.cpp:182-188): ``move`` = (side, up,
    front) deltas in the camera frame, Y locked to world up.

    Host-side helper operating on numpy pos/view_dir; returns a new Camera
    plus the updated (pos, view_dir) tuple — the functional analog of the
    reference's Input-driven camera controller (src/Input.cpp:49-97).
    """
    pos = np.asarray(pos, np.float32)
    view_dir = np.asarray(view_dir, np.float32)
    up = np.asarray(up, np.float32)
    front = view_dir * np.array([1.0, 0.0, 1.0], np.float32)
    front = front / max(np.linalg.norm(front), 1e-12)
    side = np.cross(view_dir, up)
    side = side / max(np.linalg.norm(side), 1e-12)
    new_pos = pos + front * move[2] + side * move[0] \
        + np.array([0.0, move[1], 0.0], np.float32)
    return Camera.create(new_pos, view_dir, up), (new_pos, view_dir)


def camera_rotate(cam: Camera, pos, view_dir, phi, theta,
                  up=(0.0, 1.0, 0.0)):
    """Mouse-look rotation (src/Camera.cpp:191-199): yaw ``phi`` about world
    up then pitch ``theta`` about the side axis."""
    pos = np.asarray(pos, np.float32)
    v = np.asarray(view_dir, np.float32)
    up = np.asarray(up, np.float32)

    def rot(axis, angle):
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        c, s = np.cos(angle), np.sin(angle)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]], np.float32)
        return np.eye(3, dtype=np.float32) + s * K + (1 - c) * (K @ K)

    v = rot(up, phi) @ v
    side = np.cross(v, up)
    v = rot(side, theta) @ v
    v = v / np.linalg.norm(v)
    return Camera.create(pos, v, up), (pos, v)


def camera_rotate_around_origin(cam: Camera, pos, axis, angle,
                                up=(0.0, 1.0, 0.0)):
    """RotateAroundOrigin (src/Camera.cpp:176-180): orbit the origin and
    look back at it."""
    pos = np.asarray(pos, np.float32)
    axis = np.asarray(axis, np.float32)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    c, s = np.cos(angle), np.sin(angle)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]], np.float32)
    R = np.eye(3, dtype=np.float32) + s * K + (1 - c) * (K @ K)
    new_pos = R @ pos
    view = -new_pos / max(np.linalg.norm(new_pos), 1e-12)
    return Camera.create(new_pos, view, up), (new_pos, view)
