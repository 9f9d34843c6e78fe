"""Heterogeneous participating medium: dense density grid + bounding box.

Redesign of the reference's volume stack (vk::Texture3D +
VolumeData + volume.glsl):

- The VDB is loaded once into a dense array (utils/vdb.py) and quantized to
  uint8 exactly like the reference's R8G8B8A8_UNORM upload
  (src/Texture3D.cpp:100-116: ``uint8(value * 255)``), sampled back as
  ``u8/255`` with NEAREST filtering and clamp-to-border black
  (src/Texture3D.cpp:77-82).
- The world-space box is centered at the origin with size
  ``normalize(extent) * 107.5`` (NrcHpmRenderer.cu:910-912).
- ``find_entry_exit`` replaces the reference's two-sided SDF sphere trace
  (data/shader/include/volume.glsl:7-29) with an exact ray/AABB slab test —
  same entry/exit points, but branch-free and fixed-cost (the SDF march
  has a data-dependent trip count).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .utils import pytree

# data/shader/include/nrc-constants.glsl:36-37
MAX_RAY_DISTANCE = 100000.0
MIN_RAY_DISTANCE = 0.125
# NrcHpmRenderer.cu:912 — world box scale applied to the normalized extent.
WORLD_SCALE = 107.5


# Macrocell edge in voxels for the majorant acceleration grid.
MACRO_CELL = 8


@pytree.dataclass
class Volume:
    """Density volume pytree. ``grid`` is uint8-quantized density indexed
    [x, y, z]; ``sky_size`` is the world-space box edge lengths.

    ``macro_packed`` holds, per 8^3 macrocell, a dilated MAX of the
    (quantized, normalized) density — a conservative local majorant field
    used by the piecewise tracking fast path (new acceleration; the
    reference uses the global VOLUME_DENSITY_FACTOR majorant,
    path_trace.glsl:26) — and an eroded MIN, the control density, as the
    two bf16 halves of one word.  The dilation makes a sample at any point
    dominate the true density everywhere within one macrocell edge of it."""

    grid: jax.Array            # (X, Y, Z) uint8
    macro_packed: jax.Array    # (Mx*My*Mz,) uint32 bf16(max)<<16|bf16(min)
    sky_size: jax.Array        # (3,) float32
    density_factor: jax.Array  # () float32 — VOLUME_DENSITY_FACTOR
    g: jax.Array               # () float32 — HG anisotropy VOLUME_G

    @property
    def dims(self):
        return self.grid.shape

    @property
    def macro_dims(self):
        return tuple(-(-d // MACRO_CELL) for d in self.grid.shape)

    @staticmethod
    def from_dense(data: np.ndarray, density_factor: float, g: float,
                   quantize: bool = True) -> "Volume":
        """Build from a dense [x,y,z] float array in [0,1].

        The reference fatals on unnormalized VDBs (Texture3D.cpp:74); we
        clamp-and-quantize which is equivalent for normalized inputs.
        """
        data = np.asarray(data, np.float32)
        if quantize:
            grid = (np.clip(data, 0.0, 1.0) * 255.0).astype(np.uint8)
            norm = grid.astype(np.float32) / 255.0
        else:
            # non-quantized path for oracle tests
            grid = data
            norm = data
        extent = np.array(data.shape, np.float32)
        sky_size = extent / np.linalg.norm(extent) * WORLD_SCALE
        macro_max, macro_min = _build_macro(norm)
        return Volume(
            grid=jnp.asarray(grid),
            macro_packed=jnp.asarray(_pack_macro(macro_max, macro_min)),
            sky_size=jnp.asarray(sky_size.astype(np.float32)),
            density_factor=jnp.float32(density_factor),
            g=jnp.float32(g))

    @staticmethod
    def from_vdb(path: str, density_factor: float, g: float) -> "Volume":
        from .utils.vdb import load_vdb
        return Volume.from_dense(load_vdb(path).data, density_factor, g)

    @staticmethod
    def homogeneous_cube(n: int, value: float, density_factor: float,
                         g: float) -> "Volume":
        """BASELINE config 1: homogeneous cube volume."""
        return Volume.from_dense(
            np.full((n, n, n), value, np.float32), density_factor, g)


def _upsample_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) linear-interpolation weights from a coarse lattice
    spanning [0, 1] onto n_out voxel centres."""
    pos = (np.arange(n_out) + 0.5) / n_out * (n_in - 1)
    lo = np.minimum(np.floor(pos).astype(int), n_in - 2)
    frac = pos - lo
    m = np.zeros((n_out, n_in))
    m[np.arange(n_out), lo] = 1.0 - frac
    m[np.arange(n_out), lo + 1] = frac
    return m


def seeded_cloud(seed: int, dims=(126, 86, 154),
                 empty_fraction: float = 0.78) -> np.ndarray:
    """A cloud-like float32 density grid in [0, 1], made from ``seed``.

    Stands in for the WDAS cloud where that file is absent: the default
    dims are the sixteenth grid's, and, like the WDAS box, about
    ``empty_fraction`` of it is empty.  The density is an ellipsoidal
    envelope plus four octaves of value noise, cut at the
    ``empty_fraction`` quantile, so the interior is heterogeneous and the
    edge is ragged."""
    rng = np.random.default_rng(seed)
    axes = [(np.arange(d) + 0.5) / d for d in dims]
    x, y, z = np.meshgrid(*axes, indexing="ij", sparse=True)
    r = np.sqrt(((x - 0.5) / 0.45) ** 2 + ((y - 0.42) / 0.40) ** 2
                + ((z - 0.5) / 0.45) ** 2)
    field = 1.0 - r
    amp = 0.5
    for octave in range(4):
        lattice = [4 * 2 ** octave + 1] * 3
        coarse = rng.uniform(-1.0, 1.0, lattice)
        ux, uy, uz = (_upsample_matrix(d, n) for d, n in zip(dims, lattice))
        noise = np.tensordot(coarse, uz, axes=([2], [1]))        # (a, b, k)
        noise = np.tensordot(noise, uy, axes=([1], [1]))         # (a, k, j)
        noise = np.tensordot(ux, noise, axes=([1], [0]))         # (i, k, j)
        field = field + amp * noise.transpose(0, 2, 1)
        amp *= 0.5
    cut = np.quantile(field, empty_fraction)
    dens = np.clip((field - cut) / (field.max() - cut), 0.0, 1.0)
    return (dens ** 0.75).astype(np.float32)


def seeded_volume(scene, seed: int = 0) -> "Volume":
    """``seeded_cloud(seed)`` as a Volume with a scene preset's density
    factor and HG anisotropy."""
    return Volume.from_dense(seeded_cloud(seed), scene.density,
                             scene.volume_g)


def sky_uvw(vol: Volume, pos: jax.Array) -> jax.Array:
    """World position -> [0,1]^3 texture coordinate (volume.glsl:31-34);
    the box is centered at skyPos = origin."""
    return pos / vol.sky_size + 0.5


def get_density(vol: Volume, pos: jax.Array) -> jax.Array:
    """VOLUME_DENSITY_FACTOR * nearest-sampled density, clamp-to-border
    black (volume.glsl:36-39 + the sampler config in Texture3D.cpp:77-82).

    pos: (..., 3) world positions -> (...) densities.
    """
    uvw = sky_uvw(vol, pos)
    dims = jnp.asarray(vol.dims, jnp.float32)
    idxf = jnp.floor(uvw * dims)
    inside = jnp.all((uvw >= 0.0) & (uvw < 1.0), axis=-1)
    idx = jnp.clip(idxf.astype(jnp.int32), 0,
                   jnp.asarray(vol.dims, jnp.int32) - 1)
    # flat gather — friendlier to XLA than 3-axis advanced indexing
    X, Y, Z = vol.dims
    lin = (idx[..., 0] * (Y * Z) + idx[..., 1] * Z + idx[..., 2])
    raw = jnp.take(vol.grid.reshape(-1), lin, axis=0)
    if vol.grid.dtype == jnp.uint8:
        val = raw.astype(jnp.float32) * (1.0 / 255.0)
    else:
        val = raw.astype(jnp.float32)
    return jnp.where(inside, val, 0.0) * vol.density_factor


def find_entry_exit(vol: Volume, ro: jax.Array, rd: jax.Array):
    """Ray/box entry + exit points.

    Matches the contract of find_entry_exit (volume.glsl:7-29): for a hit,
    ``entry`` is the first box point along the ray from ``ro`` (== ``ro``
    itself if inside) and ``exit`` the last; for a miss the returned points
    are far away and ``hit`` is False (callers of the reference detect this
    via ``sky_sdf(entry) > MAX_RAY_DISTANCE``, e.g. gen_rays.comp:82).

    ro, rd: (..., 3). Returns (entry, exit, hit).
    """
    half = 0.5 * vol.sky_size
    safe_rd = jnp.where(jnp.abs(rd) < 1e-12, 1e-12, rd)
    inv = 1.0 / safe_rd
    t1 = (-half - ro) * inv
    t2 = (half - ro) * inv
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < MAX_RAY_DISTANCE)
    t_entry = jnp.maximum(tmin, 0.0)
    entry = ro + t_entry[..., None] * rd
    exit_ = ro + tmax[..., None] * rd
    far = ro + (2.0 * MAX_RAY_DISTANCE) * rd
    entry = jnp.where(hit[..., None], entry, far)
    exit_ = jnp.where(hit[..., None], exit_, far)
    return entry, exit_, hit


def _shift3(a: np.ndarray, axis: int, border: float):
    """(rolled +1, rolled -1) with ``border`` filling the wrapped edge."""
    p = np.roll(a, 1, axis=axis)
    n = np.roll(a, -1, axis=axis)
    sl_first = [slice(None)] * 3
    sl_first[axis] = slice(0, 1)
    sl_last = [slice(None)] * 3
    sl_last[axis] = slice(-1, None)
    p[tuple(sl_first)] = border
    n[tuple(sl_last)] = border
    return p, n


def _build_macro(norm_grid: np.ndarray):
    """(dilated max, eroded min) of the normalized density per macrocell,
    flat (Mx*My*Mz,) float32.  The max side carries a tiny safety margin so
    fine/majorant acceptance ratios never exceed 1; the min side is the
    CONTROL density for decomposition tracking and must underestimate the
    density everywhere within one macrocell of a sample."""
    dims = norm_grid.shape
    m = [-(-d // MACRO_CELL) for d in dims]
    pad = [(0, mi * MACRO_CELL - d) for mi, d in zip(m, dims)]
    g = np.pad(norm_grid, pad)
    gmin = np.pad(norm_grid, pad, constant_values=0.0)
    cells = g.reshape(m[0], MACRO_CELL, m[1], MACRO_CELL, m[2], MACRO_CELL)
    cmax = cells.max(axis=(1, 3, 5))
    cmin = gmin.reshape(m[0], MACRO_CELL, m[1], MACRO_CELL,
                        m[2], MACRO_CELL).min(axis=(1, 3, 5))
    # edge macrocells touch the zero border outside the box
    for axis in range(3):
        sl_first = [slice(None)] * 3
        sl_first[axis] = slice(0, 1)
        sl_last = [slice(None)] * 3
        sl_last[axis] = slice(-1, None)
        cmin[tuple(sl_first)] = 0.0
        cmin[tuple(sl_last)] = 0.0
    # FACE (6-neighbor) dilation suffices for interval domination when the
    # profile takes the max of BOTH interval endpoints: an interval of
    # length <= one cell edge crosses at most one cell boundary per axis,
    # and any interior cell is a face neighbor of one of the endpoints'
    # cells.  Face-only dilation inflates the majorant far less than the
    # full 3^3 dilation (fewer null-collision events).
    dil = cmax.copy()
    ero = cmin.copy()
    for axis in range(3):
        p, n = _shift3(cmax, axis, 0.0)
        dil = np.maximum(dil, np.maximum(p, n))
        p, n = _shift3(cmin, axis, 0.0)
        ero = np.minimum(ero, np.minimum(p, n))
    # Safety margin ONLY on nonzero cells: a uniform +1e-7 floor makes
    # EVERY box-crossing ray carry rtot > 0, which permanently disables
    # the piecewise trackers' empty-lane resolution (empty = rtot <= 0)
    # and silently forced the stage-0 compaction into its dense fallback
    # on every frame.  Truly-empty dilated cells are exact zero majorants —
    # all 7 face-neighbor cells have zero density by construction.
    dil = np.where(dil > 0.0, dil * (1.0 + 1e-5) + 1e-7, 0.0)
    ero = np.minimum(ero, dil)
    return (dil.reshape(-1).astype(np.float32),
            ero.reshape(-1).astype(np.float32))


def get_density_xyz(vol: Volume, px, py, pz):
    """get_density with SEPARATE coordinate arrays (any matching shape):
    planar coordinates keep every buffer a dense lane-minor array."""
    X, Y, Z = vol.dims
    ux = px / vol.sky_size[0] + 0.5
    uy = py / vol.sky_size[1] + 0.5
    uz = pz / vol.sky_size[2] + 0.5
    inside = ((ux >= 0.0) & (ux < 1.0) & (uy >= 0.0) & (uy < 1.0)
              & (uz >= 0.0) & (uz < 1.0))
    ix = jnp.clip(jnp.floor(ux * X).astype(jnp.int32), 0, X - 1)
    iy = jnp.clip(jnp.floor(uy * Y).astype(jnp.int32), 0, Y - 1)
    iz = jnp.clip(jnp.floor(uz * Z).astype(jnp.int32), 0, Z - 1)
    lin = ix * (Y * Z) + iy * Z + iz
    raw = jnp.take(vol.grid.reshape(-1), lin, axis=0)
    if vol.grid.dtype == jnp.uint8:
        val = raw.astype(jnp.float32) * (1.0 / 255.0)
    else:
        val = raw.astype(jnp.float32)
    return jnp.where(inside, val, 0.0) * vol.density_factor


def _pack_macro(macro_max: np.ndarray, macro_min: np.ndarray) -> np.ndarray:
    """Pack (majorant, control) as bf16 halves of one uint32 with
    CONSERVATIVE rounding: the majorant is rounded UP (domination must
    survive quantization) and the control DOWN (it must stay a lower
    bound), so the piecewise estimators remain exactly unbiased."""
    # numpy has no bf16: truncate f32 bits (toward zero) after conservative
    # scaling by more than one bf16 ulp in the safe direction.
    up = macro_max.astype(np.float32) * (1.0 + 2.0 ** -7)
    dn = macro_min.astype(np.float32) * (1.0 - 2.0 ** -7)
    hi = (up.view(np.uint32) >> 16).astype(np.uint32)
    lo = (dn.astype(np.float32).view(np.uint32) >> 16).astype(np.uint32)
    packed = (hi << 16) | lo
    # verify conservativeness
    s = (packed >> np.uint32(16)).astype(np.uint32) << 16
    c = (packed & np.uint32(0xFFFF)).astype(np.uint32) << 16
    s_f = s.view(np.float32)
    c_f = np.minimum(c.view(np.float32), s_f)
    assert (s_f >= macro_max - 1e-7).all(), "majorant quantization broke"
    assert (c_f <= macro_min + 1e-7).all(), "control quantization broke"
    return packed


def macro_profile_xyz(vol: Volume, px, py, pz):
    """Fused (majorant, control) lookup on planar coordinates via the
    bf16-packed macro table: ONE lookup serves both fields (the
    coarse-profile pass of the piecewise trackers is lookup-bound).

    The majorant keeps a one-cell margin outside the box (a sample just
    outside must still dominate the in-box part of its interval); the
    control is zero outside.  A point's macrocell is its VOXEL index //
    MACRO_CELL, so cell coordinates scale by dims / MACRO_CELL (not
    macro_dims, which rounds up and would misalign cells against voxels
    when a dim is not a multiple of MACRO_CELL)."""
    mx, my, mz = vol.macro_dims
    bx, by, bz = (d / MACRO_CELL for d in vol.dims)
    cx = (px / vol.sky_size[0] + 0.5) * bx
    cy = (py / vol.sky_size[1] + 0.5) * by
    cz = (pz / vol.sky_size[2] + 0.5) * bz
    in_strict = ((cx >= 0) & (cx < bx) & (cy >= 0) & (cy < by)
                 & (cz >= 0) & (cz < bz))
    in_ext = ((cx >= -1) & (cx < bx + 1) & (cy >= -1) & (cy < by + 1)
              & (cz >= -1) & (cz < bz + 1))
    ix = jnp.clip(jnp.floor(cx).astype(jnp.int32), 0, mx - 1)
    iy = jnp.clip(jnp.floor(cy).astype(jnp.int32), 0, my - 1)
    iz = jnp.clip(jnp.floor(cz).astype(jnp.int32), 0, mz - 1)
    lin = ix * (my * mz) + iy * mz + iz
    w = jnp.take(vol.macro_packed, lin, axis=0)
    sig = jax.lax.bitcast_convert_type(
        (w & jnp.uint32(0xFFFF0000)), jnp.float32)
    ctl = jax.lax.bitcast_convert_type(w << 16, jnp.float32)
    ctl = jnp.minimum(ctl, sig)
    sig = jnp.where(in_ext, sig, 0.0) * vol.density_factor
    ctl = jnp.where(in_strict, ctl, 0.0) * vol.density_factor
    return sig, ctl
