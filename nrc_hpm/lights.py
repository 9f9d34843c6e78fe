"""Light sources: directional sun, point light, HDR environment map.

Replicates src/DirLight.cpp (direction from zenith/azimuth), src/PointLight.cpp
(uniform {pos, strength, color}), and src/HdrEnvMap.cpp + src/read_file.cpp:

- ``ReadFileHdr4f`` clamps to ``max`` then overwrites EVERY texel with 1.0
  ("Test overwrite", read_file.cpp:130), and every scene preset passes an
  empty path (a 1x1 zero texture that the overwrite also turns white,
  read_file.cpp:85-90).  Net effect: the reference's env radiance is always
  ``strength``.  We keep that default but also implement a real equirect
  lookup and the marginal/conditional inverse-CDF build (Hdr4fToCdf,
  read_file.cpp:140-223) — machinery the reference builds but whose shader
  consumer is commented out (path_trace.glsl:110-126).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .sampling import PI
from .utils import pytree


def _rot_x(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def dir_from_angles(zenith: float, azimuth: float) -> np.ndarray:
    """VecFromAngles (src/DirLight.cpp:5-14): Ry(azimuth) Rx(zenith) (0,1,0)."""
    return (_rot_y(azimuth) @ _rot_x(zenith) @ np.array([0.0, 1.0, 0.0],
                                                        np.float32))


@pytree.dataclass
class DirLight:
    color: jax.Array     # (3,)
    direction: jax.Array  # (3,) — the uniform's ``dir`` field
    strength: jax.Array  # ()
    # the generating angles, stored like the reference's members
    # (DirLight.hpp:10-11) so dynamic updates never reconstruct them from
    # the direction vector
    zenith: jax.Array    # ()
    azimuth: jax.Array   # ()

    @staticmethod
    def create(zenith=-1.57, azimuth=0.0, color=(1.0, 1.0, 1.0),
               strength=0.0) -> "DirLight":
        """HpmScene.cpp:28 constructs DirLight(-1.57, 0.0, white, strength)."""
        return DirLight(
            color=jnp.asarray(color, jnp.float32),
            direction=jnp.asarray(dir_from_angles(zenith, azimuth)),
            strength=jnp.float32(strength),
            zenith=jnp.float32(zenith),
            azimuth=jnp.float32(azimuth))


@pytree.dataclass
class PointLight:
    pos: jax.Array       # (3,)
    color: jax.Array     # (3,)
    strength: jax.Array  # ()

    @staticmethod
    def create(pos=(0.0, 0.0, 0.0), color=(1.0, 1.0, 1.0), strength=0.0
               ) -> "PointLight":
        """HpmScene.cpp:30: PointLight(origin, white, strength)."""
        return PointLight(
            pos=jnp.asarray(pos, jnp.float32),
            color=jnp.asarray(color, jnp.float32),
            strength=jnp.float32(strength))


@pytree.dataclass
class HdrEnvMap:
    image: jax.Array     # (H, W, 3) float32 radiance
    strength: jax.Array  # ()
    # Inverse CDFs for importance sampling (built, reference consumer dead):
    inv_cdf_x: jax.Array  # (H, W) conditional inverse CDF of phi given theta
    inv_cdf_y: jax.Array  # (W_Y,) marginal inverse CDF of theta

    @staticmethod
    def constant_white(strength: float) -> "HdrEnvMap":
        img = jnp.ones((1, 1, 3), jnp.float32)
        return HdrEnvMap(
            image=img, strength=jnp.float32(strength),
            inv_cdf_x=jnp.zeros((1, 1), jnp.float32),
            inv_cdf_y=jnp.zeros((1,), jnp.float32))

    @staticmethod
    def from_image(image: np.ndarray, strength: float) -> "HdrEnvMap":
        image = np.asarray(image, np.float32)[..., :3]
        cdf_x, cdf_y = build_inverse_cdfs(image)
        return HdrEnvMap(
            image=jnp.asarray(image), strength=jnp.float32(strength),
            inv_cdf_x=jnp.asarray(cdf_x), inv_cdf_y=jnp.asarray(cdf_y))


def build_inverse_cdfs(image: np.ndarray):
    """Hdr4fToCdf (src/read_file.cpp:140-223): luminance-weighted marginal
    inverse CDF over rows (theta) and conditional inverse CDF over columns
    (phi), tabulated at the source resolution."""
    h, w = image.shape[:2]
    lum = image[..., 0] * 0.2126 + image[..., 1] * 0.7152 \
        + image[..., 2] * 0.0722
    lum = np.maximum(lum, 1e-12)
    row_sum = lum.sum(axis=1)
    # marginal CDF over theta
    cdf_y = np.cumsum(row_sum) / row_sum.sum()
    inv_cdf_y = np.zeros(h, np.float32)
    u = (np.arange(h) + 0.5) / h
    inv_cdf_y = np.searchsorted(cdf_y, u).astype(np.float32) / h
    # conditional CDF over phi per row
    cdf_x = np.cumsum(lum, axis=1) / row_sum[:, None]
    inv_cdf_x = np.zeros((h, w), np.float32)
    ux = (np.arange(w) + 0.5) / w
    for r in range(h):
        inv_cdf_x[r] = np.searchsorted(cdf_x[r], ux).astype(np.float32) / w
    return inv_cdf_x, inv_cdf_y


def sample_env_map(env: HdrEnvMap, d: jax.Array) -> jax.Array:
    """SampleHdrEnvMap(vec3) (path_trace.glsl:71-86): equirect lookup
    ``uv = (atan(z,x), asin(y)) * (1/2pi, 1/pi) + 0.5`` scaled by strength.

    d: (..., 3) unit directions -> (..., 3) radiance.
    """
    h, w = env.image.shape[:2]
    if h == 1 and w == 1:
        # constant env map: avoid the gather entirely
        return jnp.broadcast_to(env.image[0, 0] * env.strength,
                                d.shape[:-1] + (3,))
    phi = jnp.arctan2(d[..., 2], d[..., 0])
    theta = jnp.arcsin(jnp.clip(d[..., 1], -1.0, 1.0))
    u = phi * (1.0 / (2.0 * PI)) + 0.5
    v = theta * (1.0 / PI) + 0.5
    # bilinear sample with wrap in u, clamp in v
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = jnp.mod(x0, w)
    x1w = jnp.mod(x0 + 1, w)
    y0c = jnp.clip(y0, 0, h - 1)
    y1c = jnp.clip(y0 + 1, 0, h - 1)
    img = env.image
    c00 = img[y0c, x0w]
    c01 = img[y0c, x1w]
    c10 = img[y1c, x0w]
    c11 = img[y1c, x1w]
    top = c00 * (1 - tx) + c01 * tx
    bot = c10 * (1 - tx) + c11 * tx
    return (top * (1 - ty) + bot * ty) * env.strength


@pytree.dataclass
class Lights:
    dir_light: DirLight
    point_light: PointLight
    env: HdrEnvMap


@dataclasses.dataclass(frozen=True)
class LightFlags:
    """Static enables — the reference skips lights with zero strength inside
    the shaders (path_trace.glsl:47,60,90); we hoist that to trace time so
    XLA removes the dead code entirely."""

    dir_on: bool
    point_on: bool
    env_on: bool

    @staticmethod
    def from_scene(scene) -> "LightFlags":
        return LightFlags(
            dir_on=scene.dir_light_strength != 0.0,
            point_on=scene.point_light_strength != 0.0,
            env_on=scene.hdr_env_map_strength != 0.0)


def lights_from_scene(scene) -> Lights:
    """Build the light set of a SceneConfig preset (HpmScene.cpp:23-54)."""
    env = HdrEnvMap.constant_white(scene.hdr_env_map_strength)
    if scene.hdr_env_map_path:
        from .utils import exr  # lazy; only used for real HDR maps
        img = exr.read_any_hdr(scene.hdr_env_map_path)
        env = HdrEnvMap.from_image(img, scene.hdr_env_map_strength)
    return Lights(
        dir_light=DirLight.create(strength=scene.dir_light_strength),
        point_light=PointLight.create(strength=scene.point_light_strength),
        env=env)


def update_scene(lights: Lights, scene, delta_time: float) -> Lights:
    """HpmScene::Update (src/HpmScene.cpp:56-76): for DYNAMIC scenes the
    reference animates the dir-light azimuth at 0.5 rad/s, wrapped with
    ``fmod(.., 2 * 3.141)`` (its literal, kept for parity) — and ONLY for
    scene id 3; the scene-4 case is an explicit no-op (HpmScene.cpp:68-70).
    Color, strength and zenith are preserved; the direction is recomputed
    from the stored angles exactly like DirLight::SetAzimuth."""
    if not scene.dynamic or scene.id != 3:
        return lights
    dl = lights.dir_light
    new_az = float((float(dl.azimuth) + delta_time * 0.5)
                   % (2.0 * 3.141))
    new_dl = DirLight.create(
        zenith=float(dl.zenith), azimuth=new_az,
        color=tuple(np.asarray(dl.color).tolist()),
        strength=float(dl.strength))
    return Lights(dir_light=new_dl, point_light=lights.point_light,
                  env=lights.env)
