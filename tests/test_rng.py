import jax.numpy as jnp
import numpy as np

from nrc_hpm.utils import rng


def _hash_np(x: np.ndarray) -> np.ndarray:
    """NumPy oracle of the Jenkins one-at-a-time round (random.glsl:24-32)."""
    x = x.astype(np.uint64)  # avoid overflow warnings; mask to 32 bits
    M = np.uint64(0xFFFFFFFF)
    x = (x + (x << np.uint64(10))) & M
    x = x ^ (x >> np.uint64(6))
    x = (x + (x << np.uint64(3))) & M
    x = x ^ (x >> np.uint64(11))
    x = (x + (x << np.uint64(15))) & M
    return x.astype(np.uint32)


def test_hash_matches_oracle():
    xs = np.array([0, 1, 123456789, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    got = np.asarray(rng.hash_u32(jnp.asarray(xs)))
    assert (got == _hash_np(xs)).all()


def test_float_construct_range():
    m = jnp.arange(0, 2**23, 9973, dtype=jnp.uint32)
    f = np.asarray(rng.float_construct(m))
    assert (f >= 0).all() and (f < 1).all()
    assert rng.float_construct(jnp.uint32(0)) == 0.0


def test_uniform_chain_deterministic():
    s0 = jnp.full((16,), 0.37, jnp.float32)
    u1, s1 = rng.uniform(s0)
    u2, s2 = rng.uniform(s1)
    u1b, _ = rng.uniform(s0)
    assert np.allclose(u1, u1b)
    assert not np.allclose(u1, u2)


def test_uniform_distribution():
    # Long chain should be ~uniform on [0, 1)
    state = rng.init_state(
        jnp.stack(jnp.meshgrid(jnp.linspace(0, 1, 64),
                               jnp.linspace(0, 1, 64)), -1).reshape(-1, 2),
        jnp.asarray([0.1, 0.7, 0.3, 0.9]))
    samples = []
    for _ in range(32):
        u, state = rng.uniform(state)
        samples.append(np.asarray(u))
    s = np.concatenate(samples)
    assert abs(s.mean() - 0.5) < 0.01
    assert abs(s.var() - 1 / 12) < 0.005
    hist, _ = np.histogram(s, bins=16, range=(0, 1))
    assert hist.min() > 0.9 * s.size / 16


def test_masked_consumption():
    s0 = jnp.asarray([0.25, 0.5], jnp.float32)
    active = jnp.asarray([True, False])
    _, s1 = rng.masked_uniform(s0, active)
    assert s1[0] != s0[0]
    assert s1[1] == s0[1]


def test_init_state_decorrelated_per_pixel():
    uv = jnp.asarray([[0.1, 0.2], [0.1, 0.21], [0.9, 0.9]], jnp.float32)
    fr = jnp.asarray([0.3, 0.4, 0.5, 0.6])
    s = np.asarray(rng.init_state(uv, fr))
    assert len(np.unique(s)) == 3
