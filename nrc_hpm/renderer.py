"""Frame renderers: Monte-Carlo ground truth and the NRC renderer.

Rebuild of src/McHpmRenderer.cpp and src/NrcHpmRenderer.cu: where
the reference records command buffers over five compute pipelines, two Vulkan
submits, an external-semaphore CUDA section and a host readback per frame
(SURVEY §3.2), here each frame is ONE jitted pure function
``state -> state`` — trace, pack, infer, train and composite fuse into a
single XLA program with no host round-trips.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .camera import Camera, pixel_rays
from .config import AppConfig
from .integrator import (TraceParams, primary_miss_mask, trace_fixed,
                         trace_primary)
from .lights import LightFlags, Lights, lights_from_scene, sample_env_map
from .utils import pytree, rng
from .volume import Volume


def _volume_from_config(cfg: AppConfig) -> Volume:
    """The scene's VDB volume.  The file is not part of the repository;
    without it this fails, and callers pass ``vol=`` (for example
    ``volume.seeded_volume(cfg.scene)``)."""
    import os
    path = cfg.scene.volume_path
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"volume {path!r} not found; pass vol= (e.g. "
            "nrc_hpm.volume.seeded_volume(cfg.scene)) to render without it")
    return Volume.from_vdb(path, cfg.scene.density, cfg.scene.volume_g)


# ---------------------------------------------------------------------------
# Monte-Carlo renderer (McHpmRenderer equivalent)
# ---------------------------------------------------------------------------

@pytree.dataclass
class McState:
    """Accumulation image + blend counter + frame PRNG key."""

    image: jax.Array       # (H, W, 4): rgb + didScatter info in w
    blend_index: jax.Array  # () int32
    key: jax.Array          # jax PRNG key for per-frame seeds


class McRenderer:
    """Pure-MC reference-quality renderer (src/McHpmRenderer.cpp:121-151,
    data/shader/mc/render.comp): per pixel one ``path_length``-bounce
    delta-tracked path per frame, temporally accumulated."""

    def __init__(self, cfg: AppConfig, vol: Optional[Volume] = None,
                 lights: Optional[Lights] = None, width: Optional[int] = None,
                 height: Optional[int] = None, path_length: Optional[int] = None,
                 blend: bool = True):
        self.cfg = cfg
        self.width = width or cfg.render_width
        self.height = height or cfg.render_height
        self.path_length = path_length or cfg.mc_path_length
        self.blend = blend
        self.vol = vol if vol is not None else _volume_from_config(cfg)
        self.lights = lights if lights is not None \
            else lights_from_scene(cfg.scene)
        self.params = TraceParams(flags=LightFlags.from_scene(cfg.scene),
                                  max_track_steps=cfg.max_track_steps,
                                  env_fixed16=cfg.env_fixed16)
        inner = partial(
            _mc_step, params=self.params, width=self.width,
            height=self.height, path_length=self.path_length,
            blend=self.blend, chunks=cfg.trace_chunks)
        self._step = jax.jit(inner)

        def _multi(state, camera, vol, lights, n):
            def body(st, _):
                return inner(st, camera, vol, lights), None
            return jax.lax.scan(body, state, None, length=n)[0]

        # n scanned steps per dispatch: at golden-generation resolutions a
        # frame runs in ~ms and per-call dispatch overhead would dominate
        self._multi_step = jax.jit(_multi, static_argnames=("n",),
                                   donate_argnums=(0,))

    def init_state(self, seed: int = 0) -> McState:
        return McState(
            image=jnp.zeros((self.height, self.width, 4), jnp.float32),
            blend_index=jnp.int32(1),
            key=jax.random.PRNGKey(seed))

    def step(self, state: McState, camera: Camera) -> McState:
        return self._step(state, camera, self.vol, self.lights)

    def multi_step(self, state: McState, camera: Camera, n: int) -> McState:
        """``n`` accumulation steps in ONE dispatch (lax.scan)."""
        return self._multi_step(state, camera, self.vol, self.lights, n=n)

    def render(self, camera: Camera, frames: int, seed: int = 0,
               steps_per_dispatch: int = 1) -> jax.Array:
        """Accumulate ``frames`` frames and return the (H, W, 4) image."""
        state = self.init_state(seed)
        done = 0
        while done < frames:
            k = min(steps_per_dispatch, frames - done)
            state = self.multi_step(state, camera, k) if k > 1 \
                else self.step(state, camera)
            done += k
        return state.image


def _mc_step(state: McState, camera: Camera, vol: Volume, lights: Lights,
             *, params: TraceParams, width: int, height: int,
             path_length: int, blend: bool, chunks: int = 1) -> McState:
    key, sub = jax.random.split(state.key)
    frame_rand = rng.frame_random(sub)

    ro, rd, frag_uv = pixel_rays(camera, width, height)
    rng_state = rng.init_state(frag_uv, frame_rand)
    n_pix = height * width
    flat_rd = rd.reshape(n_pix, 3)
    flat_ro = jnp.broadcast_to(ro, flat_rd.shape)

    def mc_chunk(s, o, d):
        miss = primary_miss_mask(vol, o, d)
        res = trace_fixed(s, vol, lights, params, o, d,
                          path_length, active=~miss)
        return res["did_scatter"], res["radiance"]

    did_scatter, radiance = _map_chunks(
        mc_chunk, chunks, rng_state.reshape(n_pix), flat_ro, flat_rd)
    did_scatter = did_scatter.reshape(height, width)
    radiance = radiance.reshape(height, width, 3)
    env_color = sample_env_map(lights.env, rd)
    rgb = jnp.where(did_scatter[..., None], radiance, env_color)
    out = jnp.concatenate(
        [rgb, did_scatter[..., None].astype(jnp.float32)], axis=-1)

    if blend:
        bf = 1.0 / state.blend_index.astype(jnp.float32)
        image = bf * out + (1.0 - bf) * state.image
        blend_index = state.blend_index + 1
    else:
        image = out
        blend_index = state.blend_index
    return McState(image=image, blend_index=blend_index, key=key)


# ---------------------------------------------------------------------------
# Shared primary-trace used by the NRC renderer (nrc/gen_rays.comp main)
# ---------------------------------------------------------------------------

def _map_chunks(fn, n_chunks: int, *arrays):
    """Run ``fn`` over leading-axis chunks with lax.map.

    Chunks whose lanes all resolve immediately (e.g. every ray misses the
    volume) cost ~nothing: the tracking while-loops see no active lane and
    never issue a gather.  Results are bitwise identical to the unchunked
    call because the fast-path RNG is stateless per lane."""
    if n_chunks <= 1 or arrays[0].shape[0] % n_chunks:
        return fn(*arrays)
    resh = tuple(a.reshape(n_chunks, a.shape[0] // n_chunks, *a.shape[1:])
                 for a in arrays)
    out = jax.lax.map(lambda args: fn(*args), resh)
    return jax.tree.map(
        lambda o: o.reshape(o.shape[0] * o.shape[1], *o.shape[2:]), out)


def primary_pass(rng_state, vol, lights, params: TraceParams, cfg: AppConfig,
                 ro, rd):
    """gen_rays.comp:53-101: short path + NRC query export.

    Returns dict with primary_color (..., 4) = (rgb, throughput),
    did_scatter, nrc_pos, nrc_dir, state.
    """
    miss = primary_miss_mask(vol, ro, rd)
    res = trace_primary(rng_state, vol, lights, params, ro, rd, cfg,
                        active=~miss)
    did_scatter = res["did_scatter"] & ~miss
    env_color = sample_env_map(lights.env, rd)
    # miss OR no-scatter -> env color with throughput 1 (gen_rays.comp:82-94)
    use_env = miss | ~did_scatter
    rgb = jnp.where(use_env[..., None], env_color, res["radiance"])
    w = jnp.where(use_env, 1.0, res["throughput"])
    primary_color = jnp.concatenate([rgb, w[..., None]], axis=-1)
    return dict(primary_color=primary_color, did_scatter=did_scatter,
                nrc_pos=res["terminal_pos"], nrc_dir=res["terminal_dir"],
                state=res["state"])


from .ops.compaction import compact_apply  # noqa: E402  (re-export)


def primary_pass_compact(rng_state, vol, lights, params: TraceParams,
                         cfg: AppConfig, ro, rd, chunks: int = 1):
    """Dense-output primary pass that traces only the rays whose pixel ray
    actually hits the volume box (~25-30% for the reference camera).

    Identical results to primary_pass up to fp reassociation; outputs match
    its contract (minus the threaded RNG state)."""
    n = rng_state.shape[0]
    miss = primary_miss_mask(vol, ro, rd)
    hit = ~miss
    valid = hit.astype(jnp.float32)

    def trace_hit(s, o, d, v):
        act = v > 0.5  # compaction fill lanes carry v == 0
        res = trace_primary(s, vol, lights, params, o, d, cfg, active=act)
        return (res["radiance"], res["throughput"],
                res["did_scatter"] & act, res["terminal_pos"],
                res["terminal_dir"])

    def traced(*args):
        return _map_chunks(trace_hit, chunks, *args)

    radiance, thr, scat, tpos, tdir = compact_apply(
        traced, hit, (rng_state, ro, rd, valid),
        out_shapes=[(3,), (), (), (3,), (3,)], capacity=n // 2)

    did_scatter = scat & hit
    env_color = sample_env_map(lights.env, rd)
    use_env = ~did_scatter
    rgb = jnp.where(use_env[..., None], env_color, radiance)
    w = jnp.where(use_env, 1.0, thr)
    primary_color = jnp.concatenate([rgb, w[..., None]], axis=-1)
    return dict(primary_color=primary_color, did_scatter=did_scatter,
                nrc_pos=tpos, nrc_dir=tdir)


# ---------------------------------------------------------------------------
# NRC renderer (NrcHpmRenderer equivalent)
# ---------------------------------------------------------------------------

from .models.nrc.cache import NeuralRadianceCache, NrcState  # noqa: E402
from .ring_buffer import RingBuffer, ring_pop, ring_push, ring_wrap  # noqa: E402
from .sampling import dir_to_spherical_norm  # noqa: E402
from .volume import sky_uvw  # noqa: E402


def infer_filtered(cache, cfg: AppConfig, nrc_state, x5, scat):
    """Batched inference with empty-batch skip — the reference's
    NrcInferFilter: batches of ``infer_batch_size`` whose pixels all
    missed are skipped (their output stays zero, matching the zero-fill
    of the infer buffers in NrcHpmRenderer.cu:1996-2000).

    The hash-grid encode is gather-bound, so inference cost scales with
    SAMPLE COUNT: compacting to the scattered pixels (~22% of the screen
    at the WDAS reference view) saves most of it, and the compaction
    gather/scatter itself is cheap row traffic.  Outputs of non-scattered
    pixels are zero, observably identical to the reference (zero-filled infer buffers + per-batch
    skip).  Shared by the single-chip and sharded renderers (each shard
    compacts its local pixels independently)."""
    n = x5.shape[0]
    if cfg.infer_compact and n >= 4096:
        def fn(x):
            return (cache.infer(nrc_state, x),)

        def dense(x):
            return (_map_chunks(
                lambda xc: cache.infer(nrc_state, xc), 16, x),)

        cap = max(int(n * cfg.infer_compact_frac), 4096)
        (out,) = compact_apply(fn, scat, (x5,), [(3,)], cap,
                               dense_fn=dense)
        return out
    b = min(cfg.infer_batch_size, n)
    if not cfg.infer_filter or n == b:
        return cache.infer(nrc_state, x5)
    nb = -(-n // b)
    pad = nb * b - n
    if pad:
        # the reference pads the infer buffer to whole batches too
        # (inferCount must be a multiple of 16, NeuralRadianceCache.cu:52)
        x5 = jnp.concatenate(
            [x5, jnp.zeros((pad, 5), x5.dtype)], axis=0)
        scat = jnp.concatenate(
            [scat, jnp.zeros((pad,), bool)], axis=0)

    def one(args):
        x5_c, scat_c = args
        return jax.lax.cond(
            jnp.any(scat_c),
            lambda: cache.infer(nrc_state, x5_c),
            lambda: jnp.zeros((b, 3), jnp.float32))

    out = jax.lax.map(one, (x5.reshape(nb, b, 5), scat.reshape(nb, b)))
    return out.reshape(nb * b, 3)[:n]


@pytree.dataclass
class NrcRenderState:
    """Per-run mutable state of the NRC renderer."""

    image: jax.Array        # (H, W, 4) blended output
    blend_index: jax.Array  # () int32
    ring: RingBuffer
    nrc: NrcState
    key: jax.Array


def pack_nrc_inputs(vol: Volume, pos: jax.Array, direction: jax.Array
                    ) -> jax.Array:
    """(pos, dir) -> the 5-float NrcInput layout.

    Position is normalized to the volume's [0,1]^3 box coordinates.
    Divergence (documented fix of SURVEY quirk 2): the reference computes
    ``pos/skySize + skySize/2`` (prep_infer_rays.comp:10) — adding half the
    WORLD SIZE (~+50) instead of 0.5; the hash grid only worked because the
    shift is consistent.  We use the intended ``pos/skySize + 0.5``.
    """
    uvw = sky_uvw(vol, pos)
    sph = dir_to_spherical_norm(direction)
    return jnp.concatenate([uvw, sph], axis=-1)


class NrcRenderer:
    """The flagship model family: online neural-radiance-cache renderer.

    One jitted ``step`` per frame does what the reference splits across five
    compute pipelines, two queue submits, an external-semaphore CUDA phase
    and a CPU filter readback (src/NrcHpmRenderer.cu:299-353):

      1. gen_rays: short primary paths + NRC query export
      2. prep_infer_rays: pack 5-float query inputs
      3. NRC inference over every pixel (the reference's per-batch skip
         filter is moot here: its default config covers all of 1080p with a
         single 2^21 batch, and XLA prefers the dense batched matmul)
      4. prep_train_rays: sparse long training paths + self-training ring
      5. trainBatchCount Adam+EMA steps
      6. composite + temporal blend

    Set ``train=False`` for frozen-cache rendering (BASELINE config 3).
    """

    def __init__(self, cfg: AppConfig, vol: Optional[Volume] = None,
                 lights: Optional[Lights] = None,
                 width: Optional[int] = None, height: Optional[int] = None,
                 show_nrc: bool = True, blend: bool = True):
        self.cfg = cfg
        self.width = width or cfg.render_width
        self.height = height or cfg.render_height
        self.vol = vol if vol is not None else _volume_from_config(cfg)
        self.lights = lights if lights is not None \
            else lights_from_scene(cfg.scene)
        self.params = TraceParams(flags=LightFlags.from_scene(cfg.scene),
                                  max_track_steps=cfg.max_track_steps,
                                  env_fixed16=cfg.env_fixed16)
        # gen_rays runs the primary operating point (no delta-phase lane
        # compaction — a measured net loss for short ~27%-hit traces)
        self.primary_params = self.params.primary_params()
        self.cache = NeuralRadianceCache(cfg)
        self.show_nrc = show_nrc
        self.blend = blend

        # CalcTrainSubset against OUR render size (the reference factors
        # 65536 over 1920x1080 into a 256x256 grid at (7,4) strides)
        tw, th, xd, yd = dataclasses.replace(
            cfg, render_width=self.width, render_height=self.height
        ).train_subset()
        self.train_w, self.train_h = tw, th
        self.train_x_dist, self.train_y_dist = xd, yd

        self._step_train = jax.jit(
            partial(self._step, train=True), donate_argnums=(0,))
        self._step_frozen = jax.jit(
            partial(self._step, train=False), donate_argnums=(0,))

    def init_state(self, seed: int = 0) -> NrcRenderState:
        key = jax.random.PRNGKey(seed)
        key, sub = jax.random.split(key)
        return NrcRenderState(
            image=jnp.zeros((self.height, self.width, 4), jnp.float32),
            blend_index=jnp.int32(1),
            ring=RingBuffer.create(self.cfg.train_ring_size),
            nrc=self.cache.init_state(sub),
            key=key)

    def _infer_filtered(self, nrc_state, x5, scat):
        return infer_filtered(self.cache, self.cfg, nrc_state, x5, scat)

    def step(self, state: NrcRenderState, camera: Camera,
             train: bool = True) -> NrcRenderState:
        fn = self._step_train if train else self._step_frozen
        return fn(state, camera, self.vol, self.lights)

    # ------------------------------------------------------------------
    def _step(self, state: NrcRenderState, camera: Camera, vol: Volume,
              lights: Lights, *, train: bool) -> NrcRenderState:
        cfg = self.cfg
        key, sub = jax.random.split(state.key)
        frame_rand = rng.frame_random(sub)

        # 1-2: primary rays + NRC queries (compacted to live rays)
        ro, rd, frag_uv = pixel_rays(camera, self.width, self.height)
        rng_state = rng.init_state(frag_uv, frame_rand)
        n_pix = self.height * self.width
        flat_rd = rd.reshape(n_pix, 3)
        flat_ro = jnp.broadcast_to(ro, flat_rd.shape)
        if cfg.compact:
            prim = primary_pass_compact(
                rng_state.reshape(n_pix), vol, lights, self.primary_params,
                cfg, flat_ro, flat_rd, chunks=cfg.trace_chunks)
        else:
            prim = _map_chunks(
                lambda s, o, d: primary_pass(s, vol, lights,
                                             self.primary_params,
                                             cfg, o, d),
                cfg.trace_chunks, rng_state.reshape(n_pix), flat_ro,
                flat_rd)

        # 3: cache inference with the per-batch skip filter ------------
        x5 = pack_nrc_inputs(vol, prim["nrc_pos"], prim["nrc_dir"])
        nrc_rgb = self._infer_filtered(state.nrc, x5, prim["did_scatter"])

        prim = {k: v.reshape(self.height, self.width, *v.shape[1:])
                for k, v in prim.items() if k != "state"}
        nrc_rgb = nrc_rgb.reshape(self.height, self.width, 3)

        # 6: composite + blend (nrc/render.comp:23-41) -----------------
        add = jnp.maximum(nrc_rgb, 0.0) * prim["primary_color"][..., 3:4]
        use = self.show_nrc & prim["did_scatter"]
        out_rgb = prim["primary_color"][..., :3] + \
            jnp.where(use[..., None], add, 0.0)
        out = jnp.concatenate(
            [out_rgb, jnp.ones_like(out_rgb[..., :1])], axis=-1)
        if self.blend:
            bf = 1.0 / state.blend_index.astype(jnp.float32)
            image = bf * out + (1.0 - bf) * state.image
            blend_index = state.blend_index + 1
        else:
            image = out
            blend_index = state.blend_index

        ring = ring_wrap(state.ring)
        nrc_state = state.nrc

        if train:
            # 4: training rays (prep_train_rays.comp main) -------------
            xs = jnp.arange(self.train_w) * self.train_x_dist
            ys = jnp.arange(self.train_h) * self.train_y_dist
            gx, gy = jnp.meshgrid(xs, ys, indexing="xy")  # (th, tw)
            scat = prim["did_scatter"][gy, gx].reshape(-1)
            qpos = prim["nrc_pos"][gy, gx].reshape(-1, 3)
            qdir = prim["nrc_dir"][gy, gx].reshape(-1, 3)

            popped, ring = ring_pop(ring, ~scat)
            t_ro = jnp.where(scat[..., None], qpos, popped[:, :3])
            t_rd = jnp.where(scat[..., None], qdir, popped[:, 3:])
            t_rd = t_rd / jnp.maximum(
                jnp.linalg.norm(t_rd, axis=-1, keepdims=True), 1e-12)

            # train RNG streams reuse the train-grid corner subwindow of
            # screen UVs (prep_train_rays.comp:108 — quirk 7, replicated)
            tx = jnp.arange(self.train_w, dtype=jnp.float32) / self.width
            ty = jnp.arange(self.train_h, dtype=jnp.float32) / self.height
            tu, tv = jnp.meshgrid(tx, ty, indexing="xy")
            t_state = rng.init_state(
                jnp.stack([tu, tv], -1).reshape(-1, 2), frame_rand)

            target = jnp.zeros_like(t_ro)
            for _ in range(cfg.train_spp):
                res = trace_fixed(t_state, vol, lights, self.params,
                                  t_ro, t_rd, cfg.train_ray_length)
                spp_rad = res["radiance"]
                if cfg.train_cache_bootstrap:
                    # terminate surviving paths into the EMA cache: add
                    # throughput-scaled prediction at the terminal
                    # (pos, dir), mirroring the composite's
                    # nrc * primary.w term (nrc/render.comp:33-37)
                    boot_x5 = pack_nrc_inputs(vol, res["terminal_pos"],
                                              res["terminal_dir"])
                    boot = jnp.maximum(
                        self.cache.infer(state.nrc, boot_x5), 0.0)
                    spp_rad = spp_rad + jnp.where(
                        res["alive"][..., None],
                        boot * res["throughput"][..., None], 0.0)
                target = target + spp_rad
                t_state = res["state"]
            target = target / cfg.train_spp
            # clamp (prep_train_rays.comp:58; 8.0 = reference parity)
            target = jnp.minimum(target, cfg.train_target_clamp)

            # scattered rays feed the ring (StoreNrcTrainData:65)
            ring = ring_push(
                ring, scat, jnp.concatenate([t_ro, t_rd], axis=-1))

            # 5: trainBatchCount optimization steps --------------------
            train_x5 = pack_nrc_inputs(vol, t_ro, t_rd)
            nrc_state = self.cache.train_frame(nrc_state, train_x5, target)

        return NrcRenderState(image=image, blend_index=blend_index,
                              ring=ring, nrc=nrc_state, key=key)


def reset_accumulation(state):
    """SetCamera semantics (NrcHpmRenderer.cu:561-604 / McHpmRenderer): a
    camera change clears the temporal accumulation.  Works for McState and
    NrcRenderState."""
    return state.replace(
        image=jnp.zeros_like(state.image),
        blend_index=jnp.int32(1))
