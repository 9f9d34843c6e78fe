"""Per-frame stage profiler — the reference's 8-query timestamp pool.

The reference brackets every NRC frame with Vulkan timestamp queries and
reports per-stage milliseconds plus "theoretical FPS"
(src/NrcHpmRenderer.cu:495-539,1950-1961, displayed at :517-539).  Our
frame is ONE jitted XLA program, so stages cannot be timestamped inside a
production step; instead this module times each stage as its own jitted
program, on the host clock around calls that end in
``jax.block_until_ready``.

Stage taxonomy mirrors the reference:
  clear        ring head/tail wrap                    (nrc/clear.comp)
  gen_rays     primary short paths + NRC query export (nrc/gen_rays.comp)
  prep_infer   5-float NrcInput pack                  (nrc/prep_infer_rays.comp)
  filter       scattered-pixel compaction index       (infer-filter readback)
  prep_train   train-ray assembly + long paths        (nrc/prep_train_rays.comp)
  nn           NRC inference + training               (the CUDA/tcnn phase)
  render       composite + temporal blend             (nrc/render.comp)

Reported numbers are per-stage device milliseconds measured in isolation;
`total` is the REAL full-step time (stages measured separately do not see
XLA's cross-stage fusion, so sum(stages) >= total is possible).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Wrap a region in a jax.profiler trace (view with xprof/tensorboard)
    — the kernel-level complement to the stage taxonomy below."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_call(fn, args, n: int = 3) -> float:
    """Seconds per call of jax.jit(fn)(*args): one warm-up call (compile),
    then ``n`` calls timed on the host clock up to block_until_ready."""
    f = jax.jit(fn)
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def profile_nrc_frame(renderer, state, camera, n: int = 3,
                      include_total: bool = True,
                      total_ms: float | None = None) -> Dict[str, float]:
    """Profile one NRC frame stage by stage.  Returns {stage: ms} plus
    'total' (the real fused step) and 'theoretical_fps' = 1000/total.

    ``include_total=False`` (or a pre-measured ``total_ms``) skips timing
    the full step, which callers that already timed it can avoid."""
    from .camera import pixel_rays
    from .renderer import (NrcRenderState, pack_nrc_inputs,  # noqa: F401
                           primary_pass_compact)
    from .ring_buffer import ring_pop, ring_push, ring_wrap
    from .utils import rng

    r = renderer
    cfg = r.cfg
    vol, lights = r.vol, r.lights
    n_pix = r.height * r.width

    key, sub = jax.random.split(state.key)
    frame_rand = rng.frame_random(sub)
    ro, rd, frag_uv = pixel_rays(camera, r.width, r.height)
    flat_rd = rd.reshape(n_pix, 3)
    flat_ro = jnp.broadcast_to(ro, flat_rd.shape)
    rng_state = rng.init_state(frag_uv, frame_rand).reshape(n_pix)

    out: Dict[str, float] = {}

    # clear -----------------------------------------------------------------
    out["clear"] = time_call(
        lambda head: ring_wrap(state.ring.replace(
            head=(head[0] * 0).astype(jnp.int32) + state.ring.head)).head,
        (jnp.zeros((1,), jnp.float32),), n) * 1e3

    # gen_rays --------------------------------------------------------------
    def gen(s, o, d):
        prim = primary_pass_compact(s, vol, lights, r.params, cfg, o, d,
                                    chunks=cfg.trace_chunks)
        return prim["primary_color"], prim["nrc_pos"], prim["did_scatter"]
    out["gen_rays"] = time_call(gen, (rng_state * 1.0, flat_ro, flat_rd),
                                n) * 1e3

    prim = primary_pass_compact(rng_state, vol, lights, r.params, cfg,
                                flat_ro, flat_rd, chunks=cfg.trace_chunks)

    # prep_infer ------------------------------------------------------------
    out["prep_infer"] = time_call(
        lambda p, d: pack_nrc_inputs(vol, p, d),
        (prim["nrc_pos"], prim["nrc_dir"]), n) * 1e3
    x5 = pack_nrc_inputs(vol, prim["nrc_pos"], prim["nrc_dir"])
    scat = prim["did_scatter"]

    # filter (compaction index build — the reference's CPU readback) --------
    cap = max(int(n_pix * cfg.infer_compact_frac), 4096)
    out["filter"] = time_call(
        lambda x, s: jnp.nonzero(s, size=cap, fill_value=n_pix)[0],
        (x5, scat), n) * 1e3

    # nn: inference ----------------------------------------------------------
    out["nn_infer"] = time_call(
        lambda ns_, x, s: r._infer_filtered(ns_, x, s),
        (state.nrc, x5, scat), n) * 1e3

    # prep_train (train-ray assembly + long paths + ring ops) ---------------
    prim_img = {k: v.reshape(r.height, r.width, *v.shape[1:])
                for k, v in prim.items()}

    def prep_train(ring, fr):
        from .integrator import trace_fixed
        xs = jnp.arange(r.train_w) * r.train_x_dist
        ys = jnp.arange(r.train_h) * r.train_y_dist
        gx, gy = jnp.meshgrid(xs, ys, indexing="xy")
        sc = prim_img["did_scatter"][gy, gx].reshape(-1)
        qpos = prim_img["nrc_pos"][gy, gx].reshape(-1, 3)
        qdir = prim_img["nrc_dir"][gy, gx].reshape(-1, 3)
        popped, ring = ring_pop(ring, ~sc)
        t_ro = jnp.where(sc[..., None], qpos, popped[:, :3])
        t_rd = jnp.where(sc[..., None], qdir, popped[:, 3:])
        t_rd = t_rd / jnp.maximum(
            jnp.linalg.norm(t_rd, axis=-1, keepdims=True), 1e-12)
        tx = jnp.arange(r.train_w, dtype=jnp.float32) / r.width
        ty = jnp.arange(r.train_h, dtype=jnp.float32) / r.height
        tu, tv = jnp.meshgrid(tx, ty, indexing="xy")
        t_state = rng.init_state(
            jnp.stack([tu, tv], -1).reshape(-1, 2), fr)
        target = jnp.zeros_like(t_ro)
        for _ in range(cfg.train_spp):
            res = trace_fixed(t_state, vol, lights, r.params, t_ro, t_rd,
                              cfg.train_ray_length)
            target = target + res["radiance"]
            t_state = res["state"]
        target = jnp.minimum(target / cfg.train_spp, 8.0)
        ring = ring_push(ring, sc, jnp.concatenate([t_ro, t_rd], -1))
        return pack_nrc_inputs(vol, t_ro, t_rd), target
    out["prep_train"] = time_call(
        lambda fr, ring: prep_train(ring, fr),
        (frame_rand, state.ring), n) * 1e3
    train_x5, target = prep_train(state.ring, frame_rand)

    # nn: training -----------------------------------------------------------
    out["nn_train"] = time_call(
        lambda x, t, s: r.cache.train_frame(s, x, t).loss,
        (train_x5, target, state.nrc), n) * 1e3
    out["nn"] = out["nn_infer"] + out["nn_train"]

    # render (composite + blend) ---------------------------------------------
    nrc_rgb = r._infer_filtered(state.nrc, x5, scat).reshape(
        r.height, r.width, 3)

    def render(img, bi):
        add = jnp.maximum(nrc_rgb, 0.0) * prim_img["primary_color"][..., 3:4]
        use = prim_img["did_scatter"]
        out_rgb = prim_img["primary_color"][..., :3] + \
            jnp.where(use[..., None], add, 0.0)
        o = jnp.concatenate([out_rgb, jnp.ones_like(out_rgb[..., :1])], -1)
        bf = 1.0 / bi.astype(jnp.float32)
        return bf * o + (1.0 - bf) * img
    out["render"] = time_call(render, (state.image, state.blend_index),
                              n) * 1e3

    # total: the real fused step --------------------------------------------
    if total_ms is not None:
        out["total"] = total_ms
    elif include_total:
        # the production jitted step (it donates its state: work on a copy)
        st = jax.tree.map(jnp.copy, state)
        st = jax.block_until_ready(renderer.step(st, camera, train=True))
        t0 = time.perf_counter()
        for _ in range(n):
            st = renderer.step(st, camera, train=True)
        jax.block_until_ready(st)
        out["total"] = (time.perf_counter() - t0) / n * 1e3
    if "total" in out:
        out["theoretical_fps"] = 1000.0 / max(out["total"], 1e-9)
    out["stage_sum"] = sum(out[k] for k in (
        "clear", "gen_rays", "prep_infer", "filter", "nn_infer",
        "prep_train", "nn_train", "render"))
    return out


def format_stage_report(stages: Dict[str, float]) -> str:
    """Human-readable per-stage table (mirrors the reference's ImGui panel,
    NrcHpmRenderer.cu:517-539)."""
    order = ["clear", "gen_rays", "prep_infer", "filter", "prep_train",
             "nn_infer", "nn_train", "nn", "render", "stage_sum", "total"]
    lines = ["frame stage breakdown (ms):"]
    for k in order:
        if k in stages:
            lines.append(f"  {k:<12s} {stages[k]:9.2f}")
    if "theoretical_fps" in stages:
        lines.append(f"  theoretical FPS: {stages['theoretical_fps']:.2f}")
    return "\n".join(lines)
