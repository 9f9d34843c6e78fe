"""Self-training ring buffer.

The reference keeps an atomic MPMC ring of (pos, dir) records that training
threads pop when their pixel produced no scatter event and push when it did
(data/shader/nrc/prep_train_rays.comp:7-31, layout
nrc-descriptors.glsl:99-104), with head/tail wrapped modulo the capacity
every frame by clear.comp:5-9.

Equivalent here: a fixed-size device array plus int32 head/tail, with
the per-thread ``atomicAdd`` slot assignment replaced by a deterministic
prefix-sum over the (flattened) train-pixel order — same semantics, no
atomics, fully vectorized.  Like the reference, pops may read slots that
were never pushed (head and tail advance at different rates); entries are
initialized to a harmless default ray instead of the reference's zero-vector
direction (which would NaN in ``normalize``; documented fix).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .utils import pytree


@pytree.dataclass
class RingBuffer:
    data: jax.Array  # (capacity, 6): pos xyz, dir xyz
    head: jax.Array  # () int32 — push cursor
    tail: jax.Array  # () int32 — pop cursor

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def create(capacity: int) -> "RingBuffer":
        d = np.zeros((max(capacity, 1), 6), np.float32)
        d[:, 3:] = 1.0 / np.sqrt(3.0)  # default dir = normalize(vec3(1))
        return RingBuffer(data=jnp.asarray(d), head=jnp.int32(0),
                          tail=jnp.int32(0))


def ring_wrap(ring: RingBuffer) -> RingBuffer:
    """clear.comp: head/tail %= capacity once per frame (overflow guard)."""
    cap = ring.capacity
    return ring.replace(head=ring.head % cap, tail=ring.tail % cap)


def ring_pop(ring: RingBuffer, want: jax.Array):
    """Pop one record per ``want`` lane (bool (N,)).

    Returns (records (N, 6), new_ring). Lanes with want=False receive the
    buffer's default slot-0 record; callers must mask.
    """
    cap = ring.capacity
    order = jnp.cumsum(want.astype(jnp.int32)) - 1
    slots = (ring.tail + order) % cap
    slots = jnp.where(want, slots, 0)
    records = jnp.take(ring.data, slots, axis=0)
    new_tail = ring.tail + jnp.sum(want.astype(jnp.int32))
    return records, ring.replace(tail=new_tail)


def ring_push(ring: RingBuffer, push: jax.Array, records: jax.Array
              ) -> RingBuffer:
    """Push ``records[i]`` for every push[i]=True lane, in lane order."""
    cap = ring.capacity
    order = jnp.cumsum(push.astype(jnp.int32)) - 1
    slots = (ring.head + order) % cap
    # route masked-off lanes out of bounds; scatter mode 'drop' ignores them
    slots = jnp.where(push, slots, cap)
    data = ring.data.at[slots].set(records, mode="drop")
    new_head = ring.head + jnp.sum(push.astype(jnp.int32))
    return ring.replace(data=data, head=new_head)
