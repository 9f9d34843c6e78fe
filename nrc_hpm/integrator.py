"""Volumetric path-tracing integrator.

One differentiable, batched core replicating the reference's three GLSL
``TracePath`` variants:

- primary/NRC short paths (data/shader/nrc/gen_rays.comp:7-51): delta-tracked
  bounces with probabilistic termination after PRIMARY_RAY_LENGTH and the
  terminal (pos, dir) exported as the NRC query;
- training paths (data/shader/nrc/prep_train_rays.comp:68-99): exactly
  TRAIN_RAY_LENGTH bounces;
- Monte-Carlo ground truth (data/shader/mc/render.comp:7-40): PATH_LENGTH
  bounces.

plus ``TraceScene`` (path_trace.glsl:133-148): single-scatter direct lighting
from the directional light, the point light, and a one-sample phase-sampled
environment term, each attenuated by ratio-tracked transmittance and weighted
by the Henyey-Greenstein phase function.

Everything is written array-at-a-time over flat ray batches with static loop
bounds and per-lane active masks — the shape XLA wants.  RNG consumption
per lane mirrors the per-thread GLSL streams (see transmittance.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

import functools

from .lights import LightFlags, Lights, sample_env_map
from .sampling import hg_phase, new_ray_dir
from .transmittance import (COMPACT_MIN_LANES, delta_track, delta_track_fast,
                            delta_track_pw, ratio_track, ratio_track_fast,
                            ratio_track_pw)
from .utils import rng
from .volume import Volume, find_entry_exit


@dataclasses.dataclass(frozen=True)
class TraceParams:
    """Static integrator parameters (compiled into the program)."""

    flags: LightFlags
    max_track_steps: int = 128
    # tracking implementation:
    #   "pw"   piecewise-majorant events in optical-depth space (fastest;
    #          empty space costs nothing)
    #   "fast" segment-vectorized global-majorant tracking
    #   "seq"  per-step loops mirroring the reference's control flow
    mode: str = "pw"
    # events/steps per vectorized segment — the tracking loops' density
    # gather volume is S x N per iteration, so a small segment wins whenever most lanes resolve within a few events (the
    # piecewise majorant makes expected events ~ optical depth, O(1-3))
    segment: int = 8
    # coarse majorant samples per track call (pw mode)
    coarse: int = 32
    # staged compaction of the unresolved tail inside the pw event loops
    # (transmittance.RATIO_STAGES / DELTA_STAGES)
    event_compact: bool = True
    # per-bounce lane compaction in trace_path: after the first delta-track
    # most lanes have exited the volume (~22% scatter on the WDAS cloud),
    # so later bounces run on a compacted lane
    # set of at most this fraction (lax.cond dense fallback).  0 disables.
    # The scene (direct-lighting) phase compacts on the post-delta alive
    # set, which is smaller — it gets its own tighter capacity.
    # The DELTA-phase compaction was measured a net LOSS for short primary
    # traces (its row gathers/scatters cost as much as the fine takes they
    # save) but a WIN for long train paths whose alive set decays over 32
    # bounces (a measurement on the previous accelerator, not yet repeated
    # on the GPU) — renderers pass primary_params() for gen_rays and
    # keep the defaults for train/MC paths.
    bounce_compact_frac: float = 0.40
    scene_compact_frac: float = 0.28
    # Golden-era env transmittance: the reference's CURRENT shader ratio-
    # tracks the env shadow segment (path_trace.glsl:104), but its checked-
    # in goldens were generated with the now-commented
    # ``GetTransmittance(pos, exit, 16)`` line directly above it
    # (path_trace.glsl:100): against reference/5/0.exr our MC measures
    # relBias +0.137 with ratio tracking and -0.015 with fixed-16 steps
    # (96x54/48-frame protocol, /tmp probe recorded in BASELINE.md), while
    # the dir-light-only goldens match ratio tracking.  True => replicate
    # the golden-era estimator for the env in-scatter term.
    env_fixed16: bool = False

    # Stage-0 capacity override for delta_track_pw (None = DELTA_PLAN's
    # default).  Set per bounce by the unrolled primary loop: bounce 2's
    # live set is the ~22% scattered lanes (measured 0.223 at the
    # reference view), far below bounce 1's 47% rtot>0 set.
    delta_stage0_cap: float | None = None

    def primary_params(self) -> "TraceParams":
        """The gen_rays operating point (short paths):
        no delta-phase lane compaction, tighter scene capacity."""
        return dataclasses.replace(self, bounce_compact_frac=0.0,
                                   scene_compact_frac=0.24)

    def second_bounce_params(self) -> "TraceParams":
        """Bounce-2 operating point for the unrolled primary loop:
        delta stage-0 sized to the scattered set (0.223 measured + 25%
        margin), scene capacity to the twice-scattered set (0.194
        measured + margin)."""
        return dataclasses.replace(self, delta_stage0_cap=0.28,
                                   scene_compact_frac=0.22)

    @property
    def ratio_track(self):
        if self.mode == "pw":
            return functools.partial(ratio_track_pw, segment=self.segment,
                                     coarse=self.coarse,
                                     compact=self.event_compact)
        if self.mode == "fast":
            return functools.partial(ratio_track_fast, segment=self.segment)
        return ratio_track

    @property
    def delta_track(self):
        if self.mode == "pw":
            return functools.partial(delta_track_pw, segment=self.segment,
                                     coarse=self.coarse,
                                     compact=self.event_compact,
                                     stage0_cap=self.delta_stage0_cap)
        if self.mode == "fast":
            return functools.partial(delta_track_fast, segment=self.segment)
        return delta_track


def trace_scene(state, vol: Volume, lights: Lights, p: TraceParams,
                pos, direction, active, env_dir=None):
    """TraceScene(pos, dir) (path_trace.glsl:133-137): direct lighting at a
    scatter point. Returns (rgb (..., 3), new_state).

    With ``env_dir`` set this is the 3-arg overload
    TraceScene(pos, dir, hdrEnvMapUniformDir) (path_trace.glsl:139-148) used
    by the ReSTIR shading pass: the environment term uses the SUPPLIED
    direction with a 16-step fixed transmittance instead of drawing a fresh
    random direction with ratio tracking.

    When more than one light needs a ratio-tracked shadow segment, the
    segments are CONCATENATED into one tracking call (pw/fast modes): each
    call's coarse-profile + event machinery is serial-depth on the frame's
    critical path, and the stateless per-lane RNG makes the batched call
    bitwise-identical to the sequential one (lane k's seed is the chain
    state it would have seen sequentially — see _track_seed)."""
    total = jnp.zeros(pos.shape, pos.dtype)

    # Gather the ratio-tracked shadow segments of every enabled light:
    # (start, end, weight_fn) where weight_fn(trans) -> rgb contribution.
    segs = []

    if p.flags.dir_on:
        # TraceDirLight (path_trace.glsl:45-56)
        dl = lights.dir_light
        to_exit_dir = -dl.direction / jnp.linalg.norm(dl.direction)
        _, exit_pt, _ = find_entry_exit(
            vol, pos, jnp.broadcast_to(to_exit_dir, pos.shape))
        phase = hg_phase(jnp.sum(dl.direction * -direction, axis=-1), vol.g)
        segs.append((pos, exit_pt,
                     lambda trans, ph=phase, dl=dl:
                     (trans * dl.strength * ph)[..., None]))

    if p.flags.point_on:
        # TracePointLight (path_trace.glsl:58-69) — note the reference
        # ratio-tracks from the LIGHT to the shading point.
        pl = lights.point_light
        lpos = jnp.broadcast_to(pl.pos, pos.shape)
        to_light = lpos - pos
        to_light = to_light / jnp.maximum(
            jnp.linalg.norm(to_light, axis=-1, keepdims=True), 1e-12)
        phase = hg_phase(jnp.sum(to_light * -direction, axis=-1), vol.g)
        segs.append((lpos, pos,
                     lambda trans, ph=phase, pl=pl:
                     pl.color * (pl.strength * trans * ph)[..., None]))

    env_sample = p.flags.env_on and env_dir is None
    batched = p.mode in ("pw", "fast") and pos.ndim == 2 \
        and (len(segs) + (1 if env_sample else 0)) > 1

    if p.flags.env_on and env_dir is not None:
        # 3-arg TraceScene (path_trace.glsl:139-148): env light from the
        # stored per-vertex direction, 16-step fixed transmittance.
        from .transmittance import fixed_step_transmittance
        _, exit_pt, _ = find_entry_exit(vol, pos, env_dir)
        trans = fixed_step_transmittance(vol, pos, exit_pt, 16)
        phase = hg_phase(jnp.sum(-direction * env_dir, axis=-1), vol.g)
        env = sample_env_map(lights.env, env_dir)
        total = total + env * (trans * phase)[..., None]
    elif env_sample and not batched:
        # Sequential fallback keeps the reference's per-thread RNG ORDER:
        # dir/point shadow tracks consume their uniforms FIRST, then the
        # env direction is drawn (path_trace.glsl:133-148 calls
        # SampleHdrEnvMap last).  The batched path below draws it up front
        # — a documented divergence of the batched mode only.
        for start, end, weight in segs:
            trans, state = p.ratio_track(state, vol, start, end,
                                         p.max_track_steps, active=active)
            total = total + weight(trans)
        segs = []
        rand_dir, state = new_ray_dir(state, direction, vol.g,
                                      phase_sampling=False, active=active)
        phase = hg_phase(jnp.sum(rand_dir * -direction, axis=-1), vol.g)
        _, exit_pt, _ = find_entry_exit(vol, pos, rand_dir)
        env = sample_env_map(lights.env, rand_dir)
        if p.env_fixed16:
            from .transmittance import fixed_step_transmittance
            trans = fixed_step_transmittance(vol, pos, exit_pt, 16)
            total = total + env * (phase * trans)[..., None]
        else:
            segs.append((pos, exit_pt,
                         lambda trans, ph=phase, env=env:
                         env * (ph * trans)[..., None]))
    elif env_sample:
        # SampleHdrEnvMap(pos, dir, 1) (path_trace.glsl:88-131): one
        # random direction from the reference's uniform-in-polar-angle
        # sampler, phase-weighted, ratio-tracked to the box exit (or the
        # golden-era 16-step estimator under env_fixed16).
        rand_dir, state = new_ray_dir(state, direction, vol.g,
                                      phase_sampling=False, active=active)
        phase = hg_phase(jnp.sum(rand_dir * -direction, axis=-1), vol.g)
        _, exit_pt, _ = find_entry_exit(vol, pos, rand_dir)
        env = sample_env_map(lights.env, rand_dir)
        if p.env_fixed16:
            from .transmittance import fixed_step_transmittance
            trans = fixed_step_transmittance(vol, pos, exit_pt, 16)
            total = total + env * (phase * trans)[..., None]
        else:
            segs.append((pos, exit_pt,
                         lambda trans, ph=phase, env=env:
                         env * (ph * trans)[..., None]))

    if len(segs) > 1 and p.mode in ("pw", "fast") and pos.ndim == 2:
        # One batched tracking call over all shadow segments.  The k-th
        # segment's lanes get the RNG chain state a k-th sequential call
        # would have started from, so draws are bitwise-identical.
        states = [state]
        for _ in range(len(segs) - 1):
            _, nxt = rng.uniform(states[-1])
            states.append(nxt)
        cat = lambda xs: jnp.concatenate(xs, axis=0)  # noqa: E731
        trans_cat, state_cat = p.ratio_track(
            cat(states), vol, cat([s[0] for s in segs]),
            cat([s[1] for s in segs]), p.max_track_steps,
            active=None if active is None else cat([active] * len(segs)))
        n = pos.shape[0]
        state = state_cat[-n:]
        for k, (_, _, weight) in enumerate(segs):
            total = total + weight(trans_cat[k * n:(k + 1) * n])
    else:
        for start, end, weight in segs:
            trans, state = p.ratio_track(state, vol, start, end,
                                         p.max_track_steps, active=active)
            total = total + weight(trans)

    return total, state


def trace_path(state, vol: Volume, lights: Lights, p: TraceParams,
               ro, rd, *, n_bounces: int,
               primary_ray_length: int | None = None,
               primary_ray_prob: float = 0.0,
               active=None, unroll: bool | None = None):
    """Shared bounce loop for all three TracePath variants.

    With ``primary_ray_length=None`` this is the fixed-length train/MC loop;
    otherwise the gen_rays probabilistic termination applies
    (gen_rays.comp:39-42).

    ro: (..., 3) ray origins (the CAMERA/pixel origin; the first segment
    starts at the box entry like the reference, gen_rays.comp:11-13);
    rd: (..., 3) unit directions.

    Returns dict with:
      radiance (..., 3), throughput (...,) == the 0.5^bounces factor,
      did_scatter (...,), terminal_pos/terminal_dir (..., 3) (the NRC query:
      last delta-track output + last sampled direction), state.
    """
    if active is None:
        active = jnp.ones(ro.shape[:-1], bool)

    entry, _, _ = find_entry_exit(vol, ro, rd)

    radiance0 = jnp.zeros_like(ro)
    factor0 = jnp.ones(ro.shape[:-1], ro.dtype)
    scat0 = jnp.zeros(ro.shape[:-1], bool)
    alive0 = active

    def phase_delta(point, direction, alive, state, p=p):
        # Find new point (DeltaTrack)
        new_point, exited, state = p.delta_track(
            state, vol, point, direction, p.max_track_steps, active=alive)
        # the reference assigns currentPoint BEFORE testing volumeExit, so
        # exit lanes still expose the random fallback point as the terminal
        point = jnp.where(alive[..., None], new_point, point)
        alive = alive & ~exited
        return point, alive, state

    def phase_scene(i, point, direction, radiance, factor, alive, state,
                    p=p):
        factor = jnp.where(alive, factor * 0.5, factor)
        light, state = trace_scene(state, vol, lights, p,
                                   point, direction, alive)
        radiance = jnp.where(alive[..., None],
                             radiance + light * factor[..., None], radiance)

        new_dir, state = new_ray_dir(state, direction, vol.g,
                                     phase_sampling=True, active=alive)
        direction = jnp.where(alive[..., None], new_dir, direction)

        if primary_ray_length is not None:
            # Probabilistic termination (gen_rays.comp:39-42). The uniform is
            # consumed only by lanes that reach the test.
            test = alive & (i >= primary_ray_length)
            u, state = rng.masked_uniform(state, test)
            terminate = test & ((u >= primary_ray_prob) | (i == 128))
            alive = alive & ~terminate
        return direction, radiance, factor, alive, state

    n_lanes = ro.shape[0] if ro.ndim == 2 else 0
    big = ro.ndim == 2 and n_lanes >= COMPACT_MIN_LANES

    def _compacted(mask, arrays, fn, cap):
        """Run fn on the mask-compacted lanes (dense fallback on overflow);
        fn maps the gathered arrays to updated versions of themselves.
        Dead lanes keep their values verbatim — their RNG chains stop
        advancing, a documented divergence from the dense path that only
        affects which (equally random) uniforms later samples see."""
        count = jnp.sum(mask)
        (idx,) = jnp.nonzero(mask, size=cap, fill_value=n_lanes)

        def compact_branch(arrays):
            # packed-row TAKE (ops/compaction.take_rows); scatters stay
            # per-array
            from .ops.compaction import take_rows
            gathered = take_rows(idx, *arrays)
            out = fn(*gathered)
            return tuple(a.at[idx].set(o, mode="drop")
                         for a, o in zip(arrays, out))

        def dense_branch(arrays):
            return tuple(fn(*arrays))

        return jax.lax.cond(count <= cap, compact_branch, dense_branch,
                            tuple(arrays))

    def make_body(p_b):
        """Bounce body with per-bounce TraceParams (the unrolled primary
        path passes a smaller-capacity p for bounce 2)."""
        use_cd = p_b.bounce_compact_frac > 0 and big
        use_cs = p_b.scene_compact_frac > 0 and big
        cap_d = max(int(n_lanes * p_b.bounce_compact_frac), 128) \
            if use_cd else 0
        cap_s = max(int(n_lanes * p_b.scene_compact_frac), 128) \
            if use_cs else 0

        def body(i, carry):
            point, direction, radiance, factor, scattered, alive, state = \
                carry

            # The bounce runs in two separately compacted phases: the
            # delta phase on lanes alive at bounce start, the scene phase
            # on the (often much smaller) set that actually scattered —
            # on the WDAS cloud only ~22% of primary rays scatter, so
            # direct lighting never runs at screen width.
            def d_fn(pt, d, al, st):
                pt2, al2, st2 = phase_delta(pt, d, al, st, p=p_b)
                return pt2, d, al2, st2

            def s_fn(pt, d, r, f, al, st):
                d2, r2, f2, al2, st2 = phase_scene(i, pt, d, r, f, al, st,
                                                   p=p_b)
                return pt, d2, r2, f2, al2, st2

            if use_cd:
                point, direction, alive, state = _compacted(
                    alive, (point, direction, alive, state), d_fn, cap_d)
            else:
                point, direction, alive, state = d_fn(
                    point, direction, alive, state)
            scattered = scattered | alive

            if use_cs:
                point, direction, radiance, factor, alive, state = \
                    _compacted(
                        alive,
                        (point, direction, radiance, factor, alive, state),
                        s_fn, cap_s)
            else:
                point, direction, radiance, factor, alive, state = s_fn(
                    point, direction, radiance, factor, alive, state)
            return (point, direction, radiance, factor, scattered, alive,
                    state)

        return body

    body = make_body(p)

    unroll_primary = (primary_ray_length is not None
                      and primary_ray_prob == 0.0 and n_bounces <= 2
                      and big) if unroll is None else unroll
    if unroll_primary:
        # Unrolled short-primary loop (the canonical gen_rays shape:
        # primary_ray_length=1, prob=0 -> exactly 2 bounces) with
        # PER-BOUNCE capacities: bounce 2 runs on the scattered ~22%,
        # so its delta stage-0 and scene caps shrink ~2x
        # (second_bounce_params).  Values are identical to the while
        # path — compaction capacities are value-transparent, and each
        # bounce is guarded by the same any-alive early exit.
        carry = (entry, rd, radiance0, factor0, scat0, alive0, state)
        for i in range(n_bounces):
            p_i = p if i == 0 else p.second_bounce_params()
            body_i = make_body(p_i)
            carry = jax.lax.cond(
                jnp.any(carry[5]),
                lambda c, i=i, b=body_i: tuple(b(jnp.int32(i), c)),
                lambda c: c, carry)
        point, direction, radiance, factor, scattered, alive, state = carry
    else:
        # while-loop with an any-alive early exit: the reference's
        # threads simply return (gen_rays.comp:39-42); for long train
        # paths most lanes exit the volume well before TRAIN_RAY_LENGTH,
        # and dead bounces would still pay compaction + profile
        # machinery under a fori_loop
        def cond(c):
            i = c[0]
            alive = c[6]
            return (i < n_bounces) & jnp.any(alive)

        def wbody(c):
            i = c[0]
            out = body(i, c[1:])
            return (i + 1,) + tuple(out)

        carry = (jnp.int32(0), entry, rd, radiance0, factor0, scat0,
                 alive0, state)
        carry = jax.lax.while_loop(cond, wbody, carry)
        _, point, direction, radiance, factor, scattered, alive, state = \
            carry

    # ``alive``: lanes still inside the volume when the bounce budget ran
    # out — the truncated-path set whose remaining in-scattered radiance
    # the reference's 32-bounce train targets silently drop
    # (prep_train_rays.comp:68-99); exposed for cache bootstrapping.
    return dict(radiance=radiance, throughput=factor, did_scatter=scattered,
                terminal_pos=point, terminal_dir=direction, alive=alive,
                state=state)


def trace_primary(state, vol, lights, p: TraceParams, ro, rd, cfg,
                  active=None):
    """gen_rays TracePath: short NRC path.  ``cfg`` is the AppConfig slice
    with primary_ray_length / primary_ray_prob / max_primary_bounces."""
    if cfg.primary_ray_prob <= 0.0:
        # with zero continuation probability the loop runs at most
        # primary_ray_length + 1 bounces — keep the compiled loop tight
        n = min(cfg.primary_ray_length + 1, cfg.max_primary_bounces)
        prob = 0.0
    else:
        n = cfg.max_primary_bounces
        prob = cfg.primary_ray_prob
    return trace_path(state, vol, lights, p, ro, rd, n_bounces=n,
                      primary_ray_length=cfg.primary_ray_length,
                      primary_ray_prob=prob, active=active)


def trace_fixed(state, vol, lights, p: TraceParams, ro, rd, n_bounces: int,
                active=None):
    """Train/MC TracePath: exactly ``n_bounces`` delta-tracked bounces."""
    return trace_path(state, vol, lights, p, ro, rd, n_bounces=n_bounces,
                      active=active)


def primary_miss_mask(vol: Volume, ro, rd):
    """Replicates the callers' miss test ``sky_sdf(entry) > MAX_RAY_DISTANCE``
    (gen_rays.comp:82, mc/render.comp:69)."""
    _, _, hit = find_entry_exit(vol, ro, rd)
    return ~hit
