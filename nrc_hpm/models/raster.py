"""ModelRenderer — the reference's "Model" renderer mode.

Equivalent of SimpleModelRenderer (src/SimpleModelRenderer.cpp:
classic Vulkan raster pass with depth test + diffuse-textured meshes).  A
rasterizer maps poorly onto XLA (scanline scatter), so this renders the
same scene content by per-pixel ray/triangle intersection — one
Möller-Trumbore test of every pixel against every triangle, nearest hit
wins (the depth test), diffuse shading from the vertex color/normal.  For
the demo-scale meshes the reference loads through assimp this is fully
data-parallel and needs no scatter at all.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..camera import Camera, pixel_rays
from .mesh import Model, flatten_model


@partial(jax.jit, static_argnames=("width", "height", "chunk"))
def _render(cam: Camera, tris, tex_stack, width: int, height: int,
            background, light_dir, chunk: int = 0):
    v0, e1, e2, n, uv, col, tex_idx = tris
    _, rd, _ = pixel_rays(cam, width, height)
    ro = jnp.broadcast_to(cam.pos, rd.shape)
    rdf = rd.reshape(-1, 3)
    rof = ro.reshape(-1, 3)

    def intersect(ro_, rd_):
        # Moller-Trumbore, batched pixels x triangles
        h = jnp.cross(rd_[:, None, :], e2[None, :, :])
        a = jnp.sum(e1[None] * h, axis=-1)
        valid = jnp.abs(a) > 1e-9
        f = jnp.where(valid, 1.0 / jnp.where(valid, a, 1.0), 0.0)
        s = ro_[:, None, :] - v0[None]
        u = f * jnp.sum(s * h, axis=-1)
        q = jnp.cross(s, e1[None])
        v = f * jnp.sum(rd_[:, None, :] * q, axis=-1)
        t = f * jnp.sum(e2[None] * q, axis=-1)
        hit = valid & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
        t = jnp.where(hit, t, jnp.inf)
        best = jnp.argmin(t, axis=1)
        tbest = jnp.take_along_axis(t, best[:, None], axis=1)[:, 0]
        ub = jnp.take_along_axis(u, best[:, None], axis=1)[:, 0]
        vb = jnp.take_along_axis(v, best[:, None], axis=1)[:, 0]
        return best, tbest, ub, vb

    best, t, u, v = intersect(rof, rdf)
    hit = jnp.isfinite(t)
    w0 = 1.0 - u - v
    n_tri = jnp.take(n, best, axis=0)            # (N, 3, 3)
    normal = (w0[:, None] * n_tri[:, 0] + u[:, None] * n_tri[:, 1]
              + v[:, None] * n_tri[:, 2])
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)
    base = jnp.take(col, best, axis=0)
    if tex_stack is not None:
        # per-fragment diffuse-texture sampling (Material.cpp /
        # Texture2D.cpp): interpolate the hit's uv with the same
        # barycentrics, bilinear-sample the triangle's texture, modulate
        # the diffuse color.  Untextured triangles (tex -1) keep base.
        from ..utils.texture import bilinear_sample_layered
        uv_tri = jnp.take(uv, best, axis=0)             # (N, 3, 2)
        frag_uv = (w0[:, None] * uv_tri[:, 0] + u[:, None] * uv_tri[:, 1]
                   + v[:, None] * uv_tri[:, 2])
        tid = jnp.take(tex_idx, best, axis=0)           # (N,)
        stack, scale = tex_stack
        texel = bilinear_sample_layered(stack, frag_uv, tid, wrap="clamp",
                                        scale=scale)
        base = jnp.where((tid >= 0)[:, None], base * texel, base)
    lambert = jnp.clip(jnp.sum(normal * -light_dir, axis=-1), 0.2, 1.0)
    rgb = base * lambert[:, None]
    out = jnp.where(hit[:, None], rgb, background)
    depth = jnp.where(hit, t, jnp.inf)
    img = jnp.concatenate([out, hit[:, None].astype(jnp.float32)], axis=-1)
    return img.reshape(height, width, 4), depth.reshape(height, width)


class ModelRenderer:
    """Renders a list of Models with nearest-hit depth resolution."""

    def __init__(self, width: int, height: int,
                 background=(0.05, 0.05, 0.08),
                 light_dir=(0.3, -0.8, 0.5)):
        self.width = width
        self.height = height
        self.background = jnp.asarray(background, jnp.float32)
        ld = jnp.asarray(light_dir, jnp.float32)
        self.light_dir = ld / jnp.linalg.norm(ld)
        self._models = []
        self._tris = None
        self._tex_stack = None

    def add_model(self, model: Model):
        self._models.append(model)
        self._tris = None

    def _flat(self):
        if self._tris is None:
            if not self._models:
                raise ValueError("no models added")
            textures = []
            parts = [flatten_model(m, textures) for m in self._models]
            self._tris = tuple(jnp.concatenate([p[i] for p in parts])
                               for i in range(7))
            if textures:
                import numpy as np
                hmax = max(t.shape[0] for t in textures)
                wmax = max(t.shape[1] for t in textures)
                # pad to a common stack shape; per-layer uv scales map
                # [0,1]^2 onto each texture's original extent
                padded, scales = [], []
                for t in textures:
                    t = np.asarray(t, np.float32)
                    scales.append([t.shape[1] / wmax, t.shape[0] / hmax])
                    if t.shape[:2] != (hmax, wmax):
                        t = np.pad(t, ((0, hmax - t.shape[0]),
                                       (0, wmax - t.shape[1]), (0, 0)),
                                   mode="edge")
                    padded.append(t)
                self._tex_stack = (jnp.asarray(np.stack(padded)),
                                   jnp.asarray(scales, jnp.float32))
            else:
                self._tex_stack = None
        return self._tris

    def render(self, camera: Camera):
        """-> (H, W, 4) image (.w = hit mask) and (H, W) depth."""
        tris = self._flat()
        return _render(camera, tris, self._tex_stack, self.width,
                       self.height, self.background, self.light_dir)
