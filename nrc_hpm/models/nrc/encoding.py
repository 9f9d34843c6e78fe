"""NRC input encodings: multiresolution hash grid + OneBlob (+ the simpler
Identity/TriangleWave/Frequency options).

tcnn-compatible redesign of the encodings the reference selects by ID
(src/AppConfig.cpp:11-87): the default is HashGrid(n_levels=16,
n_features_per_level=2, log2_hashmap_size=19, base_resolution=16,
per_level_scale=2.0) for the 3-D position composed with OneBlob(n_bins=4)
for the 2-D direction, concatenated and padded with ones to the network
input width (tcnn composite encoding semantics).

Implementation notes (Instant-NGP / tiny-cuda-nn conventions):
- level scale_l = base * 2^(l*log2(per_level_scale)) - 1,
  resolution_l = ceil(scale_l) + 1;
- a level is DENSE (linear strided index) when res^3 <= hashmap size,
  otherwise corner coords hash with primes (1, 2654435761, 805459861);
- interpolation is trilinear on pos * scale + 0.5.

Divergences (documented): dense-level corner coords are clamped to the grid
instead of tcnn's out-of-bounds read (the reference feeds out-of-range
inputs — SURVEY §2.6.2); OneBlob uses the NRC paper's Gaussian-CDF bin
integral rather than tcnn's quartic kernel approximation.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ...config import EncodingConfig

_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    n_dims: int = 3

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    def level_scale(self, level: int) -> float:
        return (math.exp2(level * math.log2(self.per_level_scale))
                * self.base_resolution - 1.0)

    def level_resolution(self, level: int) -> int:
        return int(math.ceil(self.level_scale(level))) + 1

    def level_params(self, level: int) -> int:
        res = self.level_resolution(level)
        dense = res ** self.n_dims
        n = min(dense, self.table_size)
        return (n + 7) // 8 * 8  # tcnn rounds up to a multiple of 8

    def level_is_dense(self, level: int) -> bool:
        return self.level_resolution(level) ** self.n_dims <= self.table_size

    @property
    def level_offsets(self) -> tuple:
        offs, total = [], 0
        for l in range(self.n_levels):
            offs.append(total)
            total += self.level_params(l)
        return tuple(offs + [total])

    @property
    def total_params(self) -> int:
        return self.level_offsets[-1]

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def init_hash_grid(key: jax.Array, spec: HashGridSpec) -> jax.Array:
    """tcnn initializes grid features uniform in [-1e-4, 1e-4]."""
    return jax.random.uniform(
        key, (spec.total_params, spec.n_features), jnp.float32,
        minval=-1e-4, maxval=1e-4)


def _corner_offsets(n_dims: int) -> np.ndarray:
    return np.stack(np.meshgrid(*([np.arange(2)] * n_dims),
                                indexing="ij"), -1).reshape(-1, n_dims)


def hash_grid_encode(table: jax.Array, x: jax.Array, spec: HashGridSpec
                     ) -> jax.Array:
    """x: (..., n_dims) positions (nominally in [0,1]) ->
    (..., n_levels*n_features) trilinearly interpolated features.

    Layout note: every per-corner tensor is shaped (..., L*2^d) — one FLAT
    128-wide minor axis for the default 16 levels x 8 corners — and
    features are gathered from PLANAR per-feature tables, so no buffer has
    a small trailing dim like (..., L, 8, 3).
    """
    idx, weight = _corner_indices(x, spec)

    # Planar per-feature gathers keep every buffer (..., flat)-shaped, and
    # the corner->level pooling runs as a matmul with a 0/1 selection
    # matrix instead of a reshape-based reduction over (..., L, 2^d, F).
    pool = _pool_matrix(spec)                              # (F*flat, L*F)
    planes = [jnp.take(table[:, f], idx, axis=0) * weight
              for f in range(spec.n_features)]
    g = jnp.concatenate(planes, axis=-1)                   # (..., F*flat)
    return jnp.matmul(g, pool, precision="highest")


def _corner_indices(x: jax.Array, spec: HashGridSpec):
    """(..., n_dims) positions -> (idx (..., L*2^d) int32 table rows,
    weight (..., L*2^d) trilinear weights), flat-layout."""
    L = spec.n_levels
    ncor = 1 << spec.n_dims
    corners = _corner_offsets(spec.n_dims)                 # np (2^d, d)
    flat = L * ncor

    def per_level(vals, dtype):
        return jnp.asarray(np.repeat(np.asarray(vals), ncor), dtype)

    scale_f = per_level([spec.level_scale(l) for l in range(L)], jnp.float32)
    res_f = per_level([spec.level_resolution(l) for l in range(L)],
                      jnp.int32)
    dense_f = per_level([spec.level_is_dense(l) for l in range(L)], bool)
    params_f = per_level([spec.level_params(l) for l in range(L)],
                         jnp.uint32)
    off_f = per_level(spec.level_offsets[:-1], jnp.int32)
    cor = [jnp.asarray(np.tile(corners[:, d], L), jnp.int32)
           for d in range(spec.n_dims)]

    lead = x.shape[:-1]
    weight = jnp.ones(lead + (flat,), jnp.float32)
    lin = jnp.zeros(lead + (flat,), jnp.int32)
    hsh = jnp.zeros(lead + (flat,), jnp.uint32)
    stride = jnp.ones((flat,), jnp.int32)
    for d in range(spec.n_dims):
        xs = x[..., d:d + 1] * scale_f + 0.5               # (..., flat)
        x0 = jnp.floor(xs)
        w = xs - x0
        cd = x0.astype(jnp.int32) + cor[d]
        weight = weight * jnp.where(cor[d].astype(bool), w, 1.0 - w)
        cc = jnp.clip(cd, 0, res_f - 1)
        lin = lin + cc * stride
        stride = stride * res_f
        hsh = hsh ^ (cd.astype(jnp.uint32) * jnp.uint32(_PRIMES[d % 3])) \
            if d else cd.astype(jnp.uint32) * jnp.uint32(_PRIMES[0])
    idx = jnp.where(dense_f, lin,
                    (hsh % params_f).astype(jnp.int32)) + off_f
    return idx, weight


def _pool_matrix(spec: HashGridSpec):
    """(F*L*2^d, L*F) 0/1 matrix summing each level's corners into the
    interleaved (level, feature) output layout."""
    L, ncor, F = spec.n_levels, 1 << spec.n_dims, spec.n_features
    m = np.zeros((F * L * ncor, L * F), np.float32)
    for f in range(F):
        for l in range(L):
            for c in range(ncor):
                m[f * L * ncor + l * ncor + c, l * F + f] = 1.0
    return jnp.asarray(m)


def pack_table_bf16(table: jax.Array) -> jax.Array:
    """(P, 2) f32 feature table -> (P,) uint32 with both features packed as
    bf16 halves: the inference path then needs ONE element gather per
    corner instead of two (feature precision matches tcnn's fp16 params)."""
    b0 = jax.lax.bitcast_convert_type(
        table[:, 0].astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
    b1 = jax.lax.bitcast_convert_type(
        table[:, 1].astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
    return (b0 << 16) | b1


def hash_grid_encode_packed(packed: jax.Array, x: jax.Array,
                            spec: HashGridSpec) -> jax.Array:
    """hash_grid_encode against a pack_table_bf16 table — single gather."""
    assert spec.n_features == 2, "packed path assumes 2 features"
    idx, weight = _corner_indices(x, spec)
    g = jnp.take(packed, idx, axis=0)                      # (..., flat) u32
    f0 = jax.lax.bitcast_convert_type(
        (g >> 16).astype(jnp.uint16), jnp.bfloat16).astype(jnp.float32)
    f1 = jax.lax.bitcast_convert_type(
        (g & 0xFFFF).astype(jnp.uint16), jnp.bfloat16).astype(jnp.float32)
    pool = _pool_matrix(spec)
    gcat = jnp.concatenate([f0 * weight, f1 * weight], axis=-1)
    return jnp.matmul(gcat, pool, precision="highest")


# ---------------------------------------------------------------------------
# Training-path encode: bf16 packed forward + matmul scatter backward
# ---------------------------------------------------------------------------
#
# The autodiff backward of hash_grid_encode is an XLA scatter-add.  The
# tcnn equivalent accumulates gradients with atomics (tiny-cuda-nn grid
# encoding backward); this form is a MATMUL instead: with one-hot row
# selectors OH (M, R) for the M = N*2^d corner lookups of one level and
# G[m, c*F+f] = [lane(m)==c] * w_m * gout[n(m), f], the level's gradient is
#     dtable2d (R, 128*F) = OH^T @ G.
# Viable when R = level_params/128 is small (level tables <= 2^16);
# bigger tables keep autodiff.  Whether it beats the scatter-add on the
# GPU is not yet measured.

def _level_grad_matmul(idx_l, w_l, g_l, n_rows: int, n_feat: int):
    """One level's table gradient.  idx_l, w_l: (N, 2^d) level-local entry
    indices / trilinear weights; g_l: (N, F) output grads.
    Returns (n_rows*128, F) float32."""
    N, ncor = idx_l.shape
    M = N * ncor
    r = (idx_l // 128).reshape(M)
    c = (idx_l % 128).reshape(M)
    wg = (w_l[..., None] * g_l[:, None, :]).reshape(M, n_feat)
    oh = jax.nn.one_hot(r, n_rows, dtype=jnp.bfloat16)          # (M, R)
    lane_oh = jax.nn.one_hot(c, 128, dtype=jnp.float32)         # (M, 128)
    # G[m, c*F+f] = lane_oh[m, c] * wg[m, f]
    G = (lane_oh[:, :, None] * wg[:, None, :]).reshape(M, 128 * n_feat)
    d2 = jnp.dot(oh.T, G.astype(jnp.bfloat16),
                 preferred_element_type=jnp.float32)            # (R, 128*F)
    return d2.reshape(n_rows, 128, n_feat).reshape(n_rows * 128, n_feat)


def _encode_fwd_packed(table, x, spec: HashGridSpec):
    packed = pack_table_bf16(table)
    return hash_grid_encode_packed(packed, x, spec)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def hash_grid_encode_train(table, x, spec: HashGridSpec):
    """Training-path hash-grid encode: bf16 packed-table forward (one
    gather per corner) with a custom backward that builds the table
    gradient by one-hot matmuls.  Gradients flow to
    the TABLE only (zero to x) — matching how the reference's tcnn
    trainer uses the grid (NeuralRadianceCache.cu:147-156 never
    differentiates inputs).  Feature values are bf16-rounded like tcnn's
    fp16 inference/training params."""
    return _encode_fwd_packed(table, x, spec)


def _encode_train_fwd(table, x, spec):
    out = _encode_fwd_packed(table, x, spec)
    idx, weight = _corner_indices(x, spec)
    return out, (idx, weight, x.shape)


def _encode_train_bwd(spec, res, gout):
    idx, weight, xshape = res
    L, F = spec.n_levels, spec.n_features
    ncor = 1 << spec.n_dims
    n = 1
    for d in xshape[:-1]:
        n *= d
    idx = idx.reshape(n, L, ncor)
    weight = weight.reshape(n, L, ncor)
    g = gout.reshape(n, L, F)
    offs = spec.level_offsets
    parts = []
    for l in range(L):
        n_params = spec.level_params(l)
        n_rows = -(-n_params // 128)
        # level-local indices (idx carries the global offset)
        idx_l = idx[:, l, :] - offs[l]
        d_l = _level_grad_matmul(idx_l, weight[:, l, :], g[:, l, :],
                                 n_rows, F)[:n_params]
        parts.append(d_l)
    dtable = jnp.concatenate(parts, axis=0)
    return dtable, jnp.zeros(xshape, jnp.float32)


hash_grid_encode_train.defvjp(_encode_train_fwd, _encode_train_bwd)


def use_train_fast(spec: HashGridSpec | None) -> bool:
    """The matmul-scatter backward materializes an (N*2^d, R) one-hot per
    level — viable for level tables <= 2^16; bigger tables keep the
    autodiff scatter-add."""
    return (spec is not None
            and max(spec.level_params(l)
                    for l in range(spec.n_levels)) <= (1 << 16))


def one_blob_encode(x: jax.Array, n_bins: int) -> jax.Array:
    """OneBlob encoding (NRC paper / tcnn OneBlob, n_bins per dim): the
    integral of a Gaussian of sigma = 1/n_bins centered at x over each bin.

    x: (..., d) -> (..., d*n_bins)
    """
    sigma = 1.0 / n_bins
    edges = jnp.linspace(0.0, 1.0, n_bins + 1)
    z_hi = (edges[1:] - x[..., None]) / (sigma * np.sqrt(2.0))
    z_lo = (edges[:-1] - x[..., None]) / (sigma * np.sqrt(2.0))
    feats = 0.5 * (jax.lax.erf(z_hi) - jax.lax.erf(z_lo))
    return feats.reshape(*x.shape[:-1], x.shape[-1] * n_bins)


def triangle_wave_encode(x: jax.Array, n_freqs: int) -> jax.Array:
    """tcnn TriangleWave: tri(x * 2^f) for f in [0, n_freqs)."""
    freqs = jnp.asarray([2.0 ** f for f in range(n_freqs)])
    xs = x[..., None] * freqs  # (..., d, F)
    tri = jnp.abs(2.0 * (xs - jnp.floor(xs + 0.5)))
    return tri.reshape(*x.shape[:-1], x.shape[-1] * n_freqs)


def frequency_encode(x: jax.Array, n_freqs: int) -> jax.Array:
    """NeRF-style sin/cos frequency encoding (tcnn Frequency)."""
    freqs = jnp.asarray([(2.0 ** f) * np.pi for f in range(n_freqs)])
    xs = x[..., None] * freqs
    out = jnp.concatenate([jnp.sin(xs), jnp.cos(xs)], axis=-1)
    return out.reshape(*x.shape[:-1], x.shape[-1] * n_freqs * 2)


class CompositeEncoding:
    """Position encoding ++ direction encoding, padded with ones to a
    multiple of 16 (tcnn composite/padding semantics).

    Consumes the 5-float NRC input layout (posX, posY, posZ, theta, phi) of
    NrcInput (data/shader/include/nrc-descriptors.glsl:47-54).
    """

    def __init__(self, cfg: EncodingConfig):
        self.cfg = cfg
        self.grid_spec = None
        if cfg.pos_id == 0:
            self.grid_spec = HashGridSpec(
                n_levels=cfg.n_levels,
                n_features=cfg.n_features_per_level,
                log2_table_size=cfg.log2_hashmap_size,
                base_resolution=cfg.base_resolution,
                per_level_scale=cfg.per_level_scale)
            pos_dim = self.grid_spec.out_dim
        elif cfg.pos_id == 1:
            pos_dim = 3
        elif cfg.pos_id == 2:
            pos_dim = 3 * cfg.pos_n_frequencies
        elif cfg.pos_id == 3:
            pos_dim = 3 * cfg.pos_n_frequencies * 2
        else:
            raise ValueError(f"invalid pos encoding id {cfg.pos_id}")

        if cfg.dir_id == 0:
            dir_dim = 2 * cfg.oneblob_n_bins
        elif cfg.dir_id == 1:
            dir_dim = 2
        elif cfg.dir_id == 2:
            dir_dim = 2 * cfg.dir_n_frequencies
        else:
            raise ValueError(f"invalid dir encoding id {cfg.dir_id}")

        self.raw_dim = pos_dim + dir_dim
        self.out_dim = (self.raw_dim + 15) // 16 * 16

    def init_params(self, key: jax.Array):
        if self.grid_spec is not None:
            return {"hash_table": init_hash_grid(key, self.grid_spec)}
        return {}

    def pack_params(self, params):
        """Precompute the bf16-packed hash table for fast inference."""
        if self.grid_spec is None:
            return {}
        return {"hash_table_packed": pack_table_bf16(params["hash_table"])}

    def __call__(self, params, x5: jax.Array, packed=None,
                 train_fast: bool = False) -> jax.Array:
        """x5: (..., 5) -> (..., out_dim) encoded features.

        With ``packed`` (from pack_params), the hash-grid gather uses the
        single-word bf16-packed table — half the gather traffic; use for
        inference only (no gradients through the packed table).
        With ``train_fast`` (and level tables <= 2^16), the differentiable
        bf16 path with the matmul-scatter backward is used instead of the
        f32 autodiff path."""
        pos = x5[..., :3]
        direction = x5[..., 3:5]
        cfg = self.cfg
        if cfg.pos_id == 0:
            if packed is not None:
                pos_f = hash_grid_encode_packed(
                    packed["hash_table_packed"], pos, self.grid_spec)
            elif train_fast and use_train_fast(self.grid_spec):
                pos_f = hash_grid_encode_train(params["hash_table"], pos,
                                               self.grid_spec)
            else:
                pos_f = hash_grid_encode(params["hash_table"], pos,
                                         self.grid_spec)
        elif cfg.pos_id == 1:
            pos_f = pos
        elif cfg.pos_id == 2:
            pos_f = triangle_wave_encode(pos, cfg.pos_n_frequencies)
        else:
            pos_f = frequency_encode(pos, cfg.pos_n_frequencies)

        if cfg.dir_id == 0:
            dir_f = one_blob_encode(direction, cfg.oneblob_n_bins)
        elif cfg.dir_id == 1:
            dir_f = direction
        else:
            dir_f = triangle_wave_encode(direction, cfg.dir_n_frequencies)

        out = jnp.concatenate([pos_f, dir_f], axis=-1)
        pad = self.out_dim - self.raw_dim
        if pad:
            out = jnp.concatenate(
                [out, jnp.ones(out.shape[:-1] + (pad,), out.dtype)], axis=-1)
        return out
