import jax.numpy as jnp
import numpy as np

from nrc_hpm.ring_buffer import (RingBuffer, ring_pop, ring_push,
                                     ring_wrap)


def test_push_then_pop_fifo():
    ring = RingBuffer.create(8)
    recs = jnp.arange(4 * 6, dtype=jnp.float32).reshape(4, 6)
    ring = ring_push(ring, jnp.asarray([True] * 4), recs)
    assert int(ring.head) == 4
    got, ring = ring_pop(ring, jnp.asarray([True, True, True, True]))
    assert int(ring.tail) == 4
    assert np.allclose(np.asarray(got), np.asarray(recs))


def test_masked_push_pop():
    ring = RingBuffer.create(8)
    recs = jnp.stack([jnp.full((6,), float(i)) for i in range(4)])
    push = jnp.asarray([True, False, True, False])
    ring = ring_push(ring, push, recs)
    assert int(ring.head) == 2
    want = jnp.asarray([False, True, True, False])
    got, ring = ring_pop(ring, want)
    got = np.asarray(got)
    # lane 1 pops slot 0 (record 0), lane 2 pops slot 1 (record 2)
    assert np.allclose(got[1], 0.0)
    assert np.allclose(got[2], 2.0)
    assert int(ring.tail) == 2


def test_wraparound():
    ring = RingBuffer.create(4)
    recs = jnp.stack([jnp.full((6,), float(i)) for i in range(6)])
    ring = ring_push(ring, jnp.asarray([True] * 6), recs)
    assert int(ring.head) == 6
    ring = ring_wrap(ring)
    assert int(ring.head) == 2
    # slots 0..3 hold records 4, 5, 2, 3 (later pushes wrapped over 0, 1)
    data = np.asarray(ring.data)
    assert np.allclose(data[0], 4.0)
    assert np.allclose(data[1], 5.0)
    assert np.allclose(data[2], 2.0)


def test_default_records_are_safe():
    ring = RingBuffer.create(4)
    got, _ = ring_pop(ring, jnp.asarray([True]))
    d = np.asarray(got)[0]
    # direction defaults to normalize(vec3(1)) — never a zero vector
    assert np.allclose(d[3:], 1 / np.sqrt(3), atol=1e-6)
