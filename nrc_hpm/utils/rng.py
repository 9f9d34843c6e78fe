"""Per-ray counter-free PRNG matching the reference's shader RNG.

The reference threads a single float ``randomState`` per shader invocation
through Bob Jenkins' one-at-a-time hash (data/shader/include/random.glsl:23-70):

    state' = floatConstruct(hash(floatBitsToUint(state)))
    RandFloat(m) = state' * m

and seeds it per pixel per frame from the fragment UV and a per-frame uniform
``random`` vec4 (InitRandom, random.glsl:61-64).  Because the chain is pure
integer/bit manipulation on IEEE-754 bit patterns, the identical construction
is reproducible bit-for-bit in JAX on any backend — every op here is
elementwise uint32 arithmetic.  State is a per-lane ``float32`` array threaded
functionally through the tracing loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# numpy scalars, NOT jnp: a module-level jnp scalar lives on the device and
# is captured as a jaxpr CONSTANT that lowering has to fetch back.
_MANTISSA = np.uint32(0x007FFFFF)
_ONE = np.uint32(0x3F800000)


def hash_u32(x: jax.Array) -> jax.Array:
    """One round of Jenkins one-at-a-time (random.glsl:24-32)."""
    x = x.astype(jnp.uint32)
    x = x + (x << 10)
    x = x ^ (x >> 6)
    x = x + (x << 3)
    x = x ^ (x >> 11)
    x = x + (x << 15)
    return x


def _bits(f: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(f.astype(jnp.float32), jnp.uint32)


def float_construct(m: jax.Array) -> jax.Array:
    """uint32 -> float in [0, 1) via mantissa bits (random.glsl:41-51)."""
    f = jax.lax.bitcast_convert_type((m & _MANTISSA) | _ONE, jnp.float32)
    return f - 1.0


def random1(x: jax.Array) -> jax.Array:
    return float_construct(hash_u32(_bits(x)))


def random2(x: jax.Array, y: jax.Array) -> jax.Array:
    return float_construct(hash_u32(_bits(x) ^ hash_u32(_bits(y))))


def random4(x, y, z, w) -> jax.Array:
    return float_construct(
        hash_u32(_bits(x) ^ hash_u32(_bits(y)) ^ hash_u32(_bits(z))
                 ^ hash_u32(_bits(w))))


def init_state(frag_uv: jax.Array, frame_random: jax.Array) -> jax.Array:
    """InitRandom (random.glsl:61-64).

    frag_uv: (..., 2) float32 pixel UVs; frame_random: (4,) per-frame seed
    (the reference draws it CPU-side with glm::linearRand each frame,
    NrcHpmRenderer.cu:308).
    Returns per-lane state (...,) float32.
    """
    r2 = random2(frag_uv[..., 0], frag_uv[..., 1])
    r4 = random4(frame_random[0], frame_random[1], frame_random[2],
                 frame_random[3])
    r4 = jnp.broadcast_to(r4, r2.shape)
    return random2(r2, r4)


def uniform(state: jax.Array, maxval=1.0):
    """RandFloat (random.glsl:66-70): returns (sample, new_state)."""
    new_state = random1(state)
    return new_state * maxval, new_state


def masked_uniform(state: jax.Array, active: jax.Array, maxval=1.0):
    """Draw only on ``active`` lanes; inactive lanes keep their state
    (matching per-thread divergent consumption in the reference shaders)."""
    sample, new_state = uniform(state, maxval)
    return sample, jnp.where(active, new_state, state)


def frame_random(key: jax.Array) -> jax.Array:
    """Per-frame (4,) seed vector, the analog of glm::linearRand(0,1) x4."""
    return jax.random.uniform(key, (4,), dtype=jnp.float32)
