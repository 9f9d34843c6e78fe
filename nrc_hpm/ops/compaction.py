"""Lane compaction: run a function on only the mask-selected lanes.

The array-program analog of not launching warps for dead pixels (the
reference's shaders simply branch per thread; in a batched XLA program
dead lanes still burn arithmetic and density gathers, so cost must be
removed by reshaping work to the live-lane count).  Used at three levels:

- whole-pass compaction (renderer.py: trace only box-hitting rays, encode
  only scattered pixels),
- per-bounce compaction inside the path-trace loop (integrator.py: after a
  couple of bounces most lanes have exited the volume),
- per-segment compaction inside the piecewise tracking event loops
  (transmittance.py: lanes resolve after ~rtot events; the p99 tail must
  not keep the whole batch gathering).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Packed-row gather/scatter
# ---------------------------------------------------------------------------
# Compacting k separate per-lane arrays takes k 1-D gathers.  Packing the
# arrays as COLUMNS of one (N, k) matrix first makes every take one
# contiguous-row gather (measured 4x faster on the previous accelerator;
# not yet re-measured on the GPU); the pack/unpack copies are streaming
# traffic.  Bool columns ride as f32 0/1, integer columns as
# bitcast f32 (gathers move bits, never arithmetic, so NaN patterns are
# safe; the fill value 0 bitcasts to 0 in every dtype).

def _pack_cols(arrays):
    """arrays of shape (N,) or (N, k) -> ((N, K) f32 matrix, specs)."""
    cols, specs = [], []
    for a in arrays:
        v = a[:, None] if a.ndim == 1 else a
        if v.dtype == jnp.bool_:
            cols.append(v.astype(jnp.float32))
        elif jnp.issubdtype(v.dtype, jnp.floating):
            cols.append(v.astype(jnp.float32))
        else:
            cols.append(jax.lax.bitcast_convert_type(
                v.astype(jnp.uint32) if v.dtype != jnp.int32 else v,
                jnp.float32))
        specs.append((a.ndim, a.dtype, v.shape[1]))
    return jnp.concatenate(cols, axis=1), specs


def _unpack_cols(mat, specs):
    out, o = [], 0
    for ndim, dtype, k in specs:
        v = mat[:, o:o + k]
        o += k
        if dtype == jnp.bool_:
            r = v != 0.0
        elif jnp.issubdtype(dtype, jnp.floating):
            r = v.astype(dtype)
        else:
            r = jax.lax.bitcast_convert_type(v, jnp.uint32)
            r = r.astype(dtype) if dtype != jnp.uint32 else r
        out.append(r[:, 0] if ndim == 1 else r)
    return out


def take_rows(idx, *arrays):
    """Gather lanes ``idx`` from every array via ONE packed-row take
    (zero fill for out-of-range indices).

    The matching packed-row SCATTER measured slower than per-array 1-D
    scatters on the previous accelerator, so scatters keep the per-array
    form at every call site."""
    mat, specs = _pack_cols(arrays)
    rows = jnp.take(mat, idx, axis=0, mode="fill", fill_value=0)
    return _unpack_cols(rows, specs)


def compact_apply(fn, mask, arrays, out_shapes, capacity: int,
                  dense_fn=None):
    """Run ``fn`` on only the mask-selected lanes (compacted to a static
    ``capacity``), scattering results back to full size (zeros elsewhere).

    If more than ``capacity`` lanes are live, falls back to the dense call
    via lax.cond (both branches are compiled; one executes).

    fn(*compacted_arrays) -> tuple of (capacity, ...) arrays.
    out_shapes: list of trailing shapes for the outputs (() for scalar
    per-lane outputs).
    Returns the tuple of full-size outputs.
    """
    n = mask.shape[0]
    count = jnp.sum(mask)
    (idx,) = jnp.nonzero(mask, size=capacity, fill_value=n)

    def compact_branch(args):
        gathered = [jnp.take(a, idx, axis=0, mode="fill", fill_value=0)
                    for a in args]
        outs = fn(*gathered)
        full = []
        for o, tail in zip(outs, out_shapes):
            buf = jnp.zeros((n,) + tuple(tail), o.dtype)
            # out-of-range fill indices are dropped by the scatter
            full.append(buf.at[idx].set(o, mode="drop"))
        return tuple(full)

    def dense_branch(args):
        outs = (dense_fn or fn)(*args)
        return tuple(jnp.where(
            mask.reshape((n,) + (1,) * len(tail)) if tail else mask,
            o, jnp.zeros_like(o))
            for o, tail in zip(outs, out_shapes))

    return jax.lax.cond(count <= capacity, compact_branch, dense_branch,
                        tuple(arrays))


def compact_update(fn, mask, arrays, capacity: int):
    """Like compact_apply, but for UPDATE semantics: ``fn`` maps the
    compacted arrays to updated versions of the SAME arrays; unselected
    lanes keep their original values (instead of zeros).  Falls back to a
    dense masked update when more than ``capacity`` lanes are selected.

    fn(*compacted) -> tuple of updated compacted arrays (same shapes).
    Returns the tuple of updated full-size arrays.
    """
    n = mask.shape[0]
    count = jnp.sum(mask)
    (idx,) = jnp.nonzero(mask, size=capacity, fill_value=n)

    def compact_branch(args):
        gathered = [jnp.take(a, idx, axis=0, mode="fill", fill_value=0)
                    for a in args]
        outs = fn(*gathered)
        return tuple(a.at[idx].set(o, mode="drop")
                     for a, o in zip(args, outs))

    def dense_branch(args):
        outs = fn(*args)
        return tuple(jnp.where(
            mask.reshape((n,) + (1,) * (a.ndim - 1)), o, a)
            for a, o in zip(args, outs))

    return jax.lax.cond(count <= capacity, compact_branch, dense_branch,
                        tuple(arrays))
