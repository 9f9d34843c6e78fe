"""Stochastic transmittance estimators: delta tracking and ratio tracking.

Replicates data/shader/include/path_trace.glsl as fixed-trip-count masked
loops — the vectorized form of the reference's data-dependent ``for``
loops, which already carry a hard 128-iteration cap (path_trace.glsl:34,161).
Per-lane RNG consumption is masked so each lane draws exactly as many
uniforms as the corresponding GLSL thread would, including the reference's
quirk of consuming one extra uniform on volume exit (the unconditional
fallthrough ``return rayOrigin + RandFloat(tMax)*rayDir`` at
path_trace.glsl:173 executes on loop break as well, and gen_rays.comp:24
actually USES that random fallback point as the NRC query position when a
scattered path later exits the volume — so we reproduce it faithfully).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .utils import rng
from .volume import Volume, find_entry_exit, get_density


def fixed_step_transmittance(vol: Volume, start: jax.Array, end: jax.Array,
                             count: int) -> jax.Array:
    """GetTransmittance (path_trace.glsl:1-22): deterministic ``count``-step
    Riemann product with samples at the LEFT endpoints (factor i/count)."""
    d = end - start
    seg_len = jnp.linalg.norm(d, axis=-1)
    step = seg_len / count
    # sample points at fractions i/count, i in [0, count)
    fracs = jnp.arange(count, dtype=jnp.float32) / count
    pts = start[..., None, :] + fracs[:, None] * d[..., None, :]
    dens = get_density(vol, pts)
    trans = jnp.exp(-jnp.sum(dens, axis=-1) * step)
    return jnp.where(step == 0.0, 1.0, trans)


def ratio_track(state: jax.Array, vol: Volume, start: jax.Array,
                end: jax.Array, max_steps: int = 128,
                active=None):
    """RatioTrack (path_trace.glsl:24-43): unbiased residual-ratio
    transmittance along [start, end] with majorant = density_factor.

    start/end: (..., 3). Returns (transmittance, new_state).
    """
    if active is None:
        active = jnp.ones(state.shape, bool)
    inv_max = 1.0 / vol.density_factor
    seg = end - start
    tmax = jnp.linalg.norm(seg, axis=-1)
    direction = seg / jnp.maximum(tmax, 1e-12)[..., None]

    def body(_, carry):
        t, trans, state, done = carry
        lane = active & ~done
        u, state = rng.masked_uniform(state, lane)
        t_new = t - jnp.log(1.0 - u) * inv_max
        exited = t_new >= tmax
        pos = start + t_new[..., None] * direction
        dens = get_density(vol, pos)
        apply = lane & ~exited
        trans = jnp.where(apply, trans * (1.0 - dens * inv_max), trans)
        t = jnp.where(lane, t_new, t)
        done = done | (lane & exited)
        return t, trans, state, done

    t0 = jnp.zeros_like(tmax)
    trans0 = jnp.ones_like(tmax)
    done0 = jnp.zeros(tmax.shape, bool)
    _, trans, state, _ = jax.lax.fori_loop(
        0, max_steps, body, (t0, trans0, state, done0))
    return trans, state


def delta_track(state: jax.Array, vol: Volume, ro: jax.Array, rd: jax.Array,
                max_steps: int = 128, active=None):
    """DeltaTrack (path_trace.glsl:150-174): Woodcock collision sampling to
    the box exit.

    Returns (pos, volume_exit, new_state):
      - collision lanes: pos = the sampled real-collision point,
      - exit/exhausted lanes: pos = uniformly random point on [ro, exit)
        (the reference's fallthrough return), volume_exit True only for
        lanes whose free-flight jumped past the exit.
    """
    if active is None:
        active = jnp.ones(state.shape, bool)
    inv_max = 1.0 / vol.density_factor
    _, exit_pt, _ = find_entry_exit(vol, ro, rd)
    tmax = jnp.linalg.norm(exit_pt - ro, axis=-1)

    def body(_, carry):
        t, pos, hit, exited, state = carry
        lane = active & ~hit & ~exited
        u1, state = rng.masked_uniform(state, lane)
        t_new = jnp.where(lane, t - jnp.log(1.0 - u1) * inv_max, t)
        exit_now = lane & (t_new >= tmax)
        probe = lane & ~exit_now
        u2, state = rng.masked_uniform(state, probe)
        cand = ro + t_new[..., None] * rd
        dens = get_density(vol, cand)
        hit_now = probe & (dens * inv_max > u2)
        pos = jnp.where(hit_now[..., None], cand, pos)
        return (t_new, pos, hit | hit_now, exited | exit_now, state)

    t0 = jnp.zeros_like(tmax)
    pos0 = jnp.zeros_like(ro)
    f0 = jnp.zeros(tmax.shape, bool)
    _, pos, hit, exited, state = jax.lax.fori_loop(
        0, max_steps, body, (t0, pos0, f0, f0, state))

    # Fallthrough: every non-collision lane consumes one more uniform and
    # yields a random point along the segment (path_trace.glsl:173).
    fall_lane = active & ~hit
    u3, state = rng.masked_uniform(state, fall_lane)
    fallback = ro + (u3 * tmax)[..., None] * rd
    pos = jnp.where(hit[..., None], pos, fallback)
    return pos, exited, state


# ---------------------------------------------------------------------------
# Vectorized (segment-batched) tracking
# ---------------------------------------------------------------------------
#
# The sequential loops above replicate the reference's per-thread control
# flow exactly, but each of their <=128 iterations issues a full-batch
# random gather into the density grid, serialized by the loop-carried RNG
# state.  The fast path restructures the SAME estimators:
#   1. derive a per-lane SEED from the RNG state (advancing the chain once),
#      then generate step uniforms STATELESSLY as hash(seed, step_index) —
#      results are independent of batch shape, sharding and segment size
#      (a batch-wide early exit must not change per-lane randomness);
#   2. cumsum the exponential free-flight steps -> all candidate positions;
#   3. ONE vectorized density gather per 32-step segment;
#   4. resolve hits/exits with argmax over the segment,
# with a while_loop over segments for early exit once every lane resolved.
# Estimators and statistics are unchanged (same majorant, same acceptance
# law); only the RNG stream construction differs from the sequential
# version, which tests cover statistically.

def _track_seed(state):
    """Split one indexed-draw seed off the per-lane chain: the chain
    advances exactly one step per track call, so downstream sequential
    consumers stay deterministic per lane."""
    seed = jax.lax.bitcast_convert_type(state, jnp.uint32)
    _, state = rng.uniform(state)
    return seed, state


def _indexed_draws(seed, k0, n: int, salt: int):
    """Stateless uniforms: u_k = floatConstruct(hash(seed ^ hash(salt + k)))
    for k in [k0, k0+n). seed: (...,) uint32 -> (..., n) float32."""
    ks = k0 + jnp.arange(n, dtype=jnp.uint32)
    hk = rng.hash_u32(jnp.uint32(salt) + ks)
    return rng.float_construct(rng.hash_u32(seed[..., None] ^ hk))


def ratio_track_fast(state, vol: Volume, start, end, max_steps: int = 128,
                     segment: int = 32, active=None):
    """Segment-vectorized RatioTrack. Same signature/semantics as
    ratio_track; RNG consumption is uniform across lanes (unlike the
    sequential version), and inactive lanes resolve immediately so they
    never prolong the segment loop."""
    inv_max = 1.0 / vol.density_factor
    seg_count = max(1, (max_steps + segment - 1) // segment)
    seg_len = segment if seg_count > 1 else max_steps
    seg_vec = end - start
    tmax = jnp.linalg.norm(seg_vec, axis=-1)
    direction = seg_vec / jnp.maximum(tmax, 1e-12)[..., None]
    if active is not None:
        tmax = jnp.where(active, tmax, 0.0)
    seed, state = _track_seed(state)

    def seg_body(carry):
        i, t_last, trans = carry
        u = _indexed_draws(seed, i.astype(jnp.uint32) * seg_len, seg_len,
                           salt=0x9E3779B9)
        steps = -jnp.log1p(-u) * inv_max
        t = t_last[..., None] + jnp.cumsum(steps, axis=-1)
        pos = start[..., None, :] + t[..., None] * direction[..., None, :]
        dens = get_density(vol, pos)
        factors = jnp.where(t < tmax[..., None],
                            1.0 - dens * inv_max, 1.0)
        trans = trans * jnp.prod(factors, axis=-1)
        return i + 1, t[..., -1], trans

    def seg_cond(carry):
        i, t_last, _ = carry
        return (i < seg_count) & jnp.any(t_last < tmax)

    t0 = jnp.zeros_like(tmax)
    trans0 = jnp.ones_like(tmax)
    _, _, trans = jax.lax.while_loop(
        seg_cond, seg_body, (jnp.int32(0), t0, trans0))
    return trans, state


def delta_track_fast(state, vol: Volume, ro, rd, max_steps: int = 128,
                     segment: int = 32, active=None):
    """Segment-vectorized DeltaTrack. Same contract as delta_track:
    (pos, volume_exit, state) with the random fallback point for non-hit
    lanes (path_trace.glsl:173); inactive lanes resolve immediately."""
    inv_max = 1.0 / vol.density_factor
    _, exit_pt, _ = find_entry_exit(vol, ro, rd)
    tmax = jnp.linalg.norm(exit_pt - ro, axis=-1)
    if active is not None:
        tmax = jnp.where(active, tmax, 0.0)
    seg_count = max(1, (max_steps + segment - 1) // segment)
    seg_len = segment if seg_count > 1 else max_steps
    seed, state = _track_seed(state)

    def seg_body(carry):
        i, t_last, resolved, hit, exited, t_hit = carry
        k0 = i.astype(jnp.uint32) * seg_len
        u1 = _indexed_draws(seed, k0, seg_len, salt=0x85EBCA6B)
        u2 = _indexed_draws(seed, k0, seg_len, salt=0xC2B2AE35)
        t = t_last[..., None] + jnp.cumsum(-jnp.log1p(-u1) * inv_max,
                                           axis=-1)
        pos = ro[..., None, :] + t[..., None] * rd[..., None, :]
        dens = get_density(vol, pos)
        cross = t >= tmax[..., None]
        accept = (dens * inv_max > u2) & ~cross
        event = accept | cross
        first_mask = event & (jnp.cumsum(event.astype(jnp.int32), axis=-1)
                              == 1)
        has_event = jnp.any(event, axis=-1)
        ev_accept = jnp.any(first_mask & accept, axis=-1)
        ev_t = jnp.sum(jnp.where(first_mask, t, 0.0), axis=-1)
        new = ~resolved & has_event
        hit = hit | (new & ev_accept)
        exited = exited | (new & ~ev_accept)
        t_hit = jnp.where(new & ev_accept, ev_t, t_hit)
        resolved = resolved | has_event
        return (i + 1, t[..., -1], resolved, hit, exited, t_hit)

    def seg_cond(carry):
        i, _, resolved, *_ = carry
        return (i < seg_count) & ~jnp.all(resolved)

    f0 = jnp.zeros(tmax.shape, bool)
    t0 = jnp.zeros_like(tmax)
    _, _, _, hit, exited, t_hit = jax.lax.while_loop(
        seg_cond, seg_body,
        (jnp.int32(0), t0, f0, f0, f0, t0))

    u3 = _indexed_draws(seed, jnp.uint32(0), 1, salt=0x27D4EB2F)[..., 0]
    t_final = jnp.where(hit, t_hit, u3 * tmax)
    pos = ro + t_final[..., None] * rd
    return pos, exited, state


# ---------------------------------------------------------------------------
# Piecewise-majorant tracking
# ---------------------------------------------------------------------------
#
# The _fast variants above still draw free flights against the GLOBAL
# majorant (density_factor), so rays burn a fine-grid gather on every null
# collision in empty space — and 78% of the cloud's bounding box is empty.
# This path samples tracking events in MAJORANT OPTICAL DEPTH space
# instead (non-homogeneous Woodcock tracking):
#
#   1. a cheap coarse profile of the dilated macrocell majorant field is
#      sampled at `coarse` regular points along the segment (one lookup
#      into the small bf16-packed macro table per point);
#   2. events arrive at cumulative Exp(1) depths; inverting the piecewise-
#      linear cumulative depth maps them to positions.  Empty intervals
#      have zero depth, so NO events — and no fine gathers — ever land
#      in empty space;
#   3. acceptance testing / transmittance factors use the LOCAL majorant,
#      keeping the estimators exactly unbiased (sigma_local dominates the
#      density by construction of the dilated macro grid).
#
# The estimators match the reference's delta/ratio tracking statistically;
# the event cap plays the role of the reference's 128-step cap.

from .volume import get_density_xyz, macro_profile_xyz  # noqa: E402

# Staged event-loop compaction (see _staged_ratio/_staged_delta): lanes
# resolve after ~rtot residual events but the batch keeps gathering until
# the LAST lane resolves, so after a few dense segments the unresolved
# tail is compacted to a fraction of the lanes (with a lax.cond dense
# fallback if the static capacity would overflow).  Below this lane count
# the fixed compaction cost (nonzero + takes) beats the savings.
COMPACT_MIN_LANES = 32768
# Stage plans: (capacity fraction or None, events per segment, events in
# stage — None events runs to the max_steps cap).  A None capacity runs
# the stage DENSE with no nonzero/compaction (for call sites whose lanes
# arrive pre-compacted and mostly live, the stage-0 nonzero at 2M lanes
# is pure overhead and the cap would overflow anyway); small segments with the
# any-unresolved early exit keep dense stages adaptive.  Fractions sized
# from the WDAS residual-depth percentiles (experiments/event_stats.py:
# shadow-ray rtot p50=12, p90=25, p99=34) tightened by Russian roulette.
# Two stages, not three: every additional cond stage traces+compiles two
# more full tracking bodies per call site, for little runtime gain.
# With exact-zero empty macro cells (volume._build_macro), 47% of
# reference-view lanes carry rtot > 0, so the stage-0 cap of 0.50 engages
# compaction; a stage-1 cap of 0.03 overflows to the dense branch.  The
# plans were tuned on the WDAS reference view and are not yet re-tuned
# for the GPU.
RATIO_PLAN = ((None, 8, 16), (0.08, 16, None))
DELTA_PLAN = ((0.50, 16, 16), (0.06, 16, None))


# All piecewise buffers use LANE-MINOR layout — events/intervals lead,
# lanes trail: (S, N) and (C, N) — so every per-event row is a contiguous
# run of lanes.

def _indexed_draws_lead(seed, k0, n: int, salt: int):
    """Stateless uniforms with the event axis LEADING: (n, ...) float32."""
    ks = k0 + jnp.arange(n, dtype=jnp.uint32)
    hk = rng.hash_u32(jnp.uint32(salt) + ks)
    shape = (n,) + (1,) * seed.ndim
    return rng.float_construct(rng.hash_u32(seed[None] ^ hk.reshape(shape)))


def _coarse_profile(vol: Volume, start, direction, tmax, C: int):
    """Piecewise-constant majorant/control profiles, lane-minor layout.

    start/direction: (N, 3); tmax: (N,).  Returns (sigma (C, N), c (C, N),
    ccum (C, N), rcum (C, N), h (N,)).  sigma dominates the density over
    each interval (max of the dilated macro field at both endpoints) and c
    underestimates it (min of the eroded field); domination holds for
    interval lengths up to two macrocell edges.  Served by ONE bf16-packed
    table lookup per sample point (majorant and control in one word,
    conservatively rounded — volume.py:_pack_macro)."""
    h = tmax / C
    ts = jnp.arange(C + 1, dtype=jnp.float32)[:, None] * h[None, :]
    px = start[None, :, 0] + ts * direction[None, :, 0]
    py = start[None, :, 1] + ts * direction[None, :, 1]
    pz = start[None, :, 2] + ts * direction[None, :, 2]
    smax, smin = macro_profile_xyz(vol, px, py, pz)
    sigma = jnp.maximum(smax[:-1], smax[1:])
    c = jnp.minimum(jnp.minimum(smin[:-1], smin[1:]), sigma)
    ccum = jnp.cumsum(c * h[None, :], axis=0)
    rcum = jnp.cumsum((sigma - c) * h[None, :], axis=0)
    return sigma, c, ccum, rcum, h


def _map_events(E, cum, h, fields):
    """Invert the piecewise-linear cumulative depth at event depths E
    (S, N): returns (t (S, N), beyond (S, N), [field_at_event...]).
    ``fields`` entries are (C, N) per-interval arrays.

    Selection uses TELESCOPING sums over the step indicators
    ge_c = [E >= cum_c]:  the interval index is k = sum_c ge_c and any
    per-interval field evaluates as f_0 + sum_c ge_c * (f_{c+1} - f_c) —
    2 elementwise ops per (event, interval) per field, with NO (S, C, N)
    boolean membership materialized.
    Exact because consecutive field values are bf16-scale f32s whose
    differences are representable; the conservative macro margins absorb
    the <=2^-24 relative reassociation error."""
    C = cum.shape[0]
    ge = (E[:, None, :] >= cum[None]).astype(jnp.float32)  # (S, C, N)
    k = jnp.sum(ge, axis=1)                                # interval index
    beyond = E >= cum[-1][None, :]

    def sel(f):
        # f: (C, N) per-interval values; returns f[k] with f[C-1] held for
        # beyond-events (telescoping stops at the last diff)
        d = f[1:] - f[:-1]                                 # (C-1, N)
        return f[0][None, :] + jnp.sum(ge[:, :C - 1] * d[None], axis=1)

    cum_left = jnp.concatenate([jnp.zeros_like(cum[:1]), cum[:-1]], axis=0)
    t_left = k * h[None, :]
    e_left = sel(cum_left)
    rate_h = jnp.maximum(sel(cum) - e_left, 1e-20)         # rate * h
    t = t_left + (E - e_left) * (h[None, :] / rate_h)
    outs = [sel(f) for f in fields]
    return t, beyond, outs


def _flatten_lanes(fn):
    """The piecewise implementations use lane-minor (events, N) buffers and
    assume flat 1-D lanes; this wrapper lets callers pass any lead shape
    (e.g. (H, W) image lanes)."""
    import functools

    @functools.wraps(fn)
    def wrapped(state, vol, a, b, max_steps=128, segment=16, coarse=32,
                active=None, **kw):
        lead = state.shape
        if len(lead) == 1:
            return fn(state, vol, a, b, max_steps, segment, coarse, active,
                      **kw)
        n = 1
        for d in lead:
            n *= d
        out = fn(state.reshape(n), vol, a.reshape(n, 3), b.reshape(n, 3),
                 max_steps, segment, coarse,
                 None if active is None else active.reshape(n), **kw)
        return jax.tree.map(
            lambda o: o.reshape(lead + o.shape[1:]), out)

    return wrapped


def _take(idx, *arrays):
    """Gather lanes by index with zero fill (compaction) — one packed-row
    take instead of k separate 1-D takes."""
    from .ops.compaction import take_rows
    return take_rows(idx, *arrays)


# Russian-roulette threshold for the pw ratio tracker: once a lane's
# running transmittance falls below RR_EPS it survives with probability
# trans/RR_EPS (weight reset to RR_EPS) or terminates with trans = 0.
# Exactly unbiased (E[trans] unchanged) and it caps the expected event
# count near the depth where trans ~ RR_EPS — dense cloud chords would
# otherwise burn ~2x the fine-grid gathers multiplying into a dead value.
# Divergence from the reference (which runs all 128 steps) is statistical
# only; tests cover the mean.  Set to 0.0 to disable.
RR_EPS = 1.0 / 32.0


def _ratio_rr(seed, i, trans, e_new, rtot, rr_eps):
    """Russian roulette after a fold: lanes with |trans| < rr_eps survive
    with probability |trans|/rr_eps (weight reset) or park their event
    depth past rtot (resolved)."""
    alive = e_new < rtot
    small = alive & (jnp.abs(trans) < rr_eps)
    u_rr = _indexed_draws_lead(seed, i.astype(jnp.uint32), 1,
                               salt=0x7FEB352D)[0]
    survive = u_rr * rr_eps < jnp.abs(trans)
    trans = jnp.where(small,
                      jnp.where(survive, jnp.sign(trans) * rr_eps, 0.0),
                      trans)
    e_new = jnp.where(small & ~survive,
                      jnp.maximum(rtot, e_new) + 1.0, e_new)
    return trans, e_new


def _make_ratio_body(vol, seed, start, direction, c, sigma, rcum, h,
                     segment: int, rtot=None, rr_eps: float = RR_EPS):
    """One ratio-tracking segment: draw ``segment`` Exp(1) event depths,
    invert through rcum, gather fine density, fold residual factors.
    With ``rtot`` given, applies Russian roulette after the fold (lanes
    killed by RR mark themselves resolved by pushing e_last past rtot)."""

    def body(carry):
        # ``i`` is the GLOBAL EVENT BASE (not a segment counter): a lane's
        # j-th event always draws index j regardless of stage boundaries,
        # so results are independent of the compaction schedule.
        i, e_last, trans = carry
        u = _indexed_draws_lead(seed, i.astype(jnp.uint32),
                                segment, salt=0x9E3779B9)
        E = e_last[None, :] + jnp.cumsum(-jnp.log1p(-u), axis=0)
        t, beyond, (c_at, s_at) = _map_events(E, rcum, h, (c, sigma))
        px = start[None, :, 0] + t * direction[None, :, 0]
        py = start[None, :, 1] + t * direction[None, :, 1]
        pz = start[None, :, 2] + t * direction[None, :, 2]
        dens = get_density_xyz(vol, px, py, pz)
        sres = jnp.maximum(s_at - c_at, 1e-12)
        factors = jnp.where(beyond, 1.0,
                            1.0 - jnp.clip(dens - c_at, 0.0, None) / sres)
        trans = trans * jnp.prod(factors, axis=0)
        e_new = E[-1]
        if rtot is not None and rr_eps > 0.0:
            trans, e_new = _ratio_rr(seed, i, trans, e_new, rtot, rr_eps)
        return i + segment, e_new, trans

    return body


def _run_segments(body, rtot, e0, e1: int, e_last, *acc):
    """Run ``body`` over events [e0, e1) with early exit once every lane's
    cumulative event depth passed its residual total.  ``e0`` may be a
    traced int (the carried event base from previous stages)."""

    def cond(carry):
        i, e_last = carry[0], carry[1]
        return (i < e1) & jnp.any(e_last < rtot)

    e0 = jnp.asarray(e0, jnp.int32)
    out = jax.lax.while_loop(cond, body, (e0, e_last) + acc)
    return out


@_flatten_lanes
def ratio_track_pw(state, vol: Volume, start, end, max_steps: int = 128,
                   segment: int = 16, coarse: int = 32, active=None,
                   compact: bool = True):
    """Residual ratio tracking with piecewise control/majorant:
    T = exp(-int c) * E[ prod over residual events (1 - (d - c)/(sigma - c)) ].
    Same contract as ratio_track; fine-grid gathers happen only at residual
    events, i.e. where the density actually varies.

    Staged per RATIO_PLAN: compact immediately to the rtot>0 survivors of
    the upfront RR, burn one big event burst, mop up the tail at narrow
    caps (bitwise-identical results: event draws are stateless, indexed by
    a global event counter)."""
    seg_vec = end - start
    tmax = jnp.linalg.norm(seg_vec, axis=-1)
    direction = seg_vec / jnp.maximum(tmax, 1e-12)[..., None]
    if active is not None:
        tmax = jnp.where(active, tmax, 0.0)
    seed, state = _track_seed(state)
    sigma, c, ccum, rcum, h = _coarse_profile(vol, start, direction, tmax,
                                              coarse)
    rtot = rcum[-1]
    ctot = ccum[-1]
    n = tmax.shape[0]

    t0 = jnp.zeros_like(tmax)
    # Fold the analytic control factor exp(-ctot) in UP FRONT (same
    # expectation — it is deterministic given the profile) so Russian
    # roulette sees the full running transmittance: chords through the
    # cloud interior carry exp(-ctot) ~ 1e-3..1e-9 and can terminate
    # before burning ANY fine-grid gathers on a dead product.
    trans0 = jnp.exp(-ctot)
    if RR_EPS > 0.0:
        small0 = (trans0 < RR_EPS) & (t0 < rtot)
        u0 = _indexed_draws_lead(seed, jnp.uint32(0), 1,
                                 salt=0x3C6EF372)[0]
        survive0 = u0 * RR_EPS < trans0
        t0 = jnp.where(small0 & ~survive0,
                       jnp.maximum(rtot, t0) + 1.0, t0)
        trans0 = jnp.where(small0,
                           jnp.where(survive0, RR_EPS, 0.0), trans0)

    if not compact or n < COMPACT_MIN_LANES:
        body = _make_ratio_body(vol, seed, start, direction, c, sigma,
                                rcum, h, segment, rtot=rtot)
        _, e_last, trans = _run_segments(body, rtot, 0, max_steps, t0,
                                         trans0)
        return trans, state

    e_base = jnp.int32(0)     # global event counter, carried across stages
    e_last, trans = t0, trans0
    e0 = 0                    # static lower bound of the current stage
    for frac, seg_len, n_events in RATIO_PLAN:
        e1 = max_steps if n_events is None else min(e0 + n_events,
                                                    max_steps)
        if e1 <= e0:
            break
        if frac is None:
            body = _make_ratio_body(vol, seed, start, direction, c, sigma,
                                    rcum, h, seg_len, rtot=rtot)
            e_base, e_last, trans = _run_segments(body, rtot, e_base, e1,
                                                  e_last, trans)
            e0 = e1
            continue
        cap = max(int(n * frac), 128)
        unres = e_last < rtot
        count = jnp.sum(unres)
        (idx,) = jnp.nonzero(unres, size=cap, fill_value=n)

        def compact_branch(args, e1=e1, idx=idx, seg_len=seg_len):
            e_base, e_last, trans = args
            seed_c, tmax_c, e_c, tr_c, start_c, dir_c = _take(
                idx, seed, tmax, e_last, trans, start, direction)
            sg, cc, _, rc, hh = _coarse_profile(vol, start_c, dir_c,
                                                tmax_c, coarse)
            rtot_c = rc[-1]
            body_c = _make_ratio_body(vol, seed_c, start_c, dir_c, cc,
                                      sg, rc, hh, seg_len, rtot=rtot_c)
            e_base, e_c, tr_c = _run_segments(body_c, rtot_c, e_base, e1,
                                              e_c, tr_c)
            # per-array scatters (ops/compaction.take_rows explains why
            # the scatter side is not packed)
            return (e_base, e_last.at[idx].set(e_c, mode="drop"),
                    trans.at[idx].set(tr_c, mode="drop"))

        def dense_branch(args, e1=e1, seg_len=seg_len):
            e_base, e_last, trans = args
            body = _make_ratio_body(vol, seed, start, direction, c, sigma,
                                    rcum, h, seg_len, rtot=rtot)
            return _run_segments(body, rtot, e_base, e1, e_last, trans)

        e_base, e_last, trans = jax.lax.cond(
            count <= cap, compact_branch, dense_branch,
            (e_base, e_last, trans))
        e0 = e1
        if e0 >= max_steps:
            break

    return trans, state


def _make_delta_body(vol, seed, ro, rd, c, sigma, rcum, h, segment: int):
    """One delta-tracking segment over the residual stream: draw events,
    invert to positions, gather fine density, resolve accept/cross."""

    def body(carry):
        # ``i`` is the global event base, as in _make_ratio_body
        i, e_last, resolved, res_hit, crossed, t_res = carry
        k0 = i.astype(jnp.uint32)
        u1 = _indexed_draws_lead(seed, k0, segment, salt=0x85EBCA6B)
        u2 = _indexed_draws_lead(seed, k0, segment, salt=0xC2B2AE35)
        E = e_last[None, :] + jnp.cumsum(-jnp.log1p(-u1), axis=0)
        t, beyond, (c_at, s_at) = _map_events(E, rcum, h, (c, sigma))
        px = ro[None, :, 0] + t * rd[None, :, 0]
        py = ro[None, :, 1] + t * rd[None, :, 1]
        pz = ro[None, :, 2] + t * rd[None, :, 2]
        dens = get_density_xyz(vol, px, py, pz)
        sres = jnp.maximum(s_at - c_at, 1e-12)
        accept = ~beyond & (jnp.clip(dens - c_at, 0.0, None) / sres > u2)
        event = accept | beyond
        # first event via cumulative masking (elementwise; a
        # take_along_axis here would be a gather)
        first_mask = event & (jnp.cumsum(event.astype(jnp.int32), axis=0)
                              == 1)
        has_event = jnp.any(event, axis=0)
        ev_accept = jnp.any(first_mask & accept, axis=0)
        ev_t = jnp.sum(jnp.where(first_mask, t, 0.0), axis=0)
        new = ~resolved & has_event
        res_hit = res_hit | (new & ev_accept)
        crossed = crossed | (new & ~ev_accept)
        t_res = jnp.where(new & ev_accept, ev_t, t_res)
        resolved = resolved | has_event
        return (i + segment, E[-1], resolved, res_hit, crossed, t_res)

    return body


def _run_delta_segments(body, e0, e1: int, carry):
    """Run delta over events [e0, e1) with early exit once all resolved."""

    def cond(c):
        i, resolved = c[0], c[2]
        return (i < e1) & ~jnp.all(resolved)

    e0 = jnp.asarray(e0, jnp.int32)
    out = jax.lax.while_loop(cond, body, (e0,) + tuple(carry))
    return out


@_flatten_lanes
def delta_track_pw(state, vol: Volume, ro, rd, max_steps: int = 128,
                   segment: int = 16, coarse: int = 32, active=None,
                   compact: bool = True, stage0_cap: float | None = None):
    """Decomposition delta tracking: the control component's first collision
    is sampled ANALYTICALLY (no density lookups); only residual events —
    concentrated where the density varies — gather the fine grid.  The
    first arrival of either stream is the collision (superposition of
    independent Poisson processes).  Same contract as delta_track.

    Staged per DELTA_PLAN: empty lanes resolve analytically before stage 0
    (see ratio_track_pw for the scheme)."""
    _, exit_pt, _ = find_entry_exit(vol, ro, rd)
    tmax = jnp.linalg.norm(exit_pt - ro, axis=-1)
    if active is not None:
        tmax = jnp.where(active, tmax, 0.0)
    seed, state = _track_seed(state)
    n = tmax.shape[0]
    sigma, c, ccum, rcum, h = _coarse_profile(vol, ro, rd, tmax, coarse)
    ctot = ccum[-1]
    rtot = rcum[-1]

    # control collision: one Exp(1) draw inverted through ccum
    e_ctrl = -jnp.log1p(-_indexed_draws_lead(
        seed, jnp.uint32(0), 1, salt=0x165667B1)[0])
    t_ctrl_raw, ctrl_beyond, _ = _map_events(e_ctrl[None, :], ccum, h, ())
    ctrl_hit = (~ctrl_beyond[0]) & (e_ctrl < ctot)
    t_ctrl = jnp.where(ctrl_hit, t_ctrl_raw[0], jnp.inf)

    f0 = jnp.zeros(tmax.shape, bool)
    t0 = jnp.zeros_like(tmax)
    inf0 = jnp.full(tmax.shape, jnp.inf)
    # lanes with zero residual depth resolve analytically: their first
    # event is necessarily beyond rtot (crossed), no fine gathers needed —
    # this makes the stage-0 compaction skip them entirely
    empty = rtot <= 0.0
    carry = (t0, empty, f0, empty, inf0)  # e_last, resolved, hit, crossed, t_res

    if not compact or n < COMPACT_MIN_LANES:
        body = _make_delta_body(vol, seed, ro, rd, c, sigma, rcum, h,
                                segment)
        carry = _run_delta_segments(body, 0, max_steps, carry)[1:]
    else:
        e_base = jnp.int32(0)
        e0 = 0
        for stage_i, (frac, seg_len, n_events) in enumerate(DELTA_PLAN):
            if stage_i == 0 and stage0_cap is not None and frac is not None:
                # caller-supplied stage-0 capacity (per-bounce tuning:
                # the second primary bounce's live set is the ~22%
                # scattered lanes, far below the first bounce's 47%)
                frac = stage0_cap
            e1 = max_steps if n_events is None else min(e0 + n_events,
                                                        max_steps)
            if e1 <= e0:
                break
            if frac is None:
                body = _make_delta_body(vol, seed, ro, rd, c, sigma, rcum,
                                        h, seg_len)
                out = _run_delta_segments(body, e_base, e1, carry)
                e_base, carry = out[0], tuple(out[1:])
                e0 = e1
                continue
            cap = max(int(n * frac), 128)
            unres = ~carry[1]
            count = jnp.sum(unres)
            (idx,) = jnp.nonzero(unres, size=cap, fill_value=n)

            def compact_branch(args, e1=e1, idx=idx, seg_len=seg_len):
                e_base, carry = args[0], args[1:]
                seed_c, tmax_c, ro_c, rd_c, *cc = _take(
                    idx, seed, tmax, ro, rd, *carry)
                # fill lanes must not run: mark them resolved
                cc[1] = cc[1] | (idx >= n)
                sg, ct, _, rc, hh = _coarse_profile(vol, ro_c, rd_c,
                                                    tmax_c, coarse)
                body_c = _make_delta_body(vol, seed_c, ro_c, rd_c, ct,
                                          sg, rc, hh, seg_len)
                out = _run_delta_segments(body_c, e_base, e1, tuple(cc))
                # per-array scatters beat the packed-row form (see ratio)
                return (out[0],) + tuple(
                    a.at[idx].set(o, mode="drop")
                    for a, o in zip(carry, out[1:]))

            def dense_branch(args, e1=e1, seg_len=seg_len):
                e_base, carry = args[0], args[1:]
                body = _make_delta_body(vol, seed, ro, rd, c, sigma, rcum,
                                        h, seg_len)
                return _run_delta_segments(body, e_base, e1, carry)

            out = jax.lax.cond(count <= cap, compact_branch, dense_branch,
                               (e_base,) + tuple(carry))
            e_base, carry = out[0], tuple(out[1:])
            e0 = e1
            if e0 >= max_steps:
                break

    _, resolved, res_hit, crossed, t_res = carry
    t_res = jnp.where(res_hit, t_res, jnp.inf)

    # superpose the two streams: earliest collision wins
    t_star = jnp.minimum(t_ctrl, t_res)
    hit = t_star <= tmax
    exited = ~hit & crossed & ~ctrl_hit

    u3 = _indexed_draws(seed, jnp.uint32(0), 1, salt=0x27D4EB2F)[..., 0]
    t_final = jnp.where(hit, t_star, u3 * tmax)
    pos = ro + t_final[..., None] * rd
    return pos, exited, state
