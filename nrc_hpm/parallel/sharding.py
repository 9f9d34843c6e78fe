"""Multi-chip execution: ray-sharded rendering + replicated NRC training.

The reference is strictly single-GPU (SURVEY §5: no distributed anything) —
this module is new capability:

- Mesh: one ``rays`` axis (data parallel over pixel rows).  The NRC network
  is ~50 MB of parameters (hash table dominated), far below HBM; parameters
  stay REPLICATED and gradients are ``psum``-averaged across devices inside the
  jitted step, overlapping with the backward pass under XLA's scheduler.
  Tensor/pipeline parallelism would only add latency for a 64-wide MLP, so
  the mesh is deliberately 1-D; the step is still expressed with shard_map
  + PartitionSpecs so wider meshes are a config change, not a rewrite.
- Each device renders a contiguous block of image rows.  The sparse train
  subset (65536 of 2M pixels) is split evenly across devices by flat index;
  instead of all-gathering scattered primary-pass outputs, every device
  RE-TRACES its own train pixels' primary rays from global coordinates —
  the per-lane RNG streams are pure functions of (pixel UV, frame seed), so
  the re-trace reproduces the main pass bit-exactly at ~0.4% extra work and
  zero collectives.
- Ring buffers are per-shard (capacity ring_size / n); pushes/pops stay
  device-local, mirroring the reference's nondeterministic atomic ordering
  with a deterministic shard-local order.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..camera import Camera, rays_for_uv
from ..config import AppConfig
from ..integrator import TraceParams, trace_fixed
from ..lights import LightFlags, Lights, lights_from_scene
from ..renderer import (NrcRenderState, _volume_from_config, pack_nrc_inputs,
                        primary_pass, primary_pass_compact)
from ..ring_buffer import RingBuffer, ring_pop, ring_push, ring_wrap
from ..models.nrc.cache import NeuralRadianceCache
from ..utils import rng
from ..volume import Volume


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "rays"
              ) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis_name,))


class ShardedNrcRenderer:
    """NRC renderer with pixels sharded over a 1-D device mesh.

    State layout: image sharded by rows, ring + RNG key per-shard, NRC
    params/opt-state replicated.  The whole frame remains ONE jitted
    program; XLA inserts the gradient psums.
    """

    def __init__(self, cfg: AppConfig, mesh: Optional[Mesh] = None,
                 vol: Optional[Volume] = None,
                 lights: Optional[Lights] = None,
                 show_nrc: bool = True, blend: bool = True):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.mesh.rays, cfg.mesh.axis_name)
        self.axis = self.mesh.axis_names[0]
        self.n = self.mesh.devices.size
        self.width = cfg.render_width
        self.height = cfg.render_height
        self.out_height = cfg.render_height
        # pad rows up to the mesh size: the padded rows trace harmless
        # out-of-frame rays (v >= 1) and are cropped by final_image()
        self.pad_h = -(-self.height // self.n) * self.n
        self.local_h = self.pad_h // self.n
        self.vol = vol if vol is not None else _volume_from_config(cfg)
        self.lights = lights if lights is not None \
            else lights_from_scene(cfg.scene)
        self.params = TraceParams(flags=LightFlags.from_scene(cfg.scene),
                                  max_track_steps=cfg.max_track_steps,
                                  env_fixed16=cfg.env_fixed16)
        # gen_rays operating point, matching the single-chip renderer
        # (delta-phase lane compaction is a measured net loss for short
        # primary traces).  Results are bitwise
        # identical either way (stateless event draws); this is perf only.
        self.primary_params = self.params.primary_params()
        self.cache = NeuralRadianceCache(cfg)
        self.show_nrc = show_nrc
        self.blend = blend

        tw, th, xd, yd = cfg.train_subset()
        self.train_w, self.train_h, self.train_x_dist, self.train_y_dist = \
            tw, th, xd, yd
        n_train = tw * th
        # per-BATCH padding: global batch bs_g splits into ceil(bs_g/n)
        # lanes per shard; the overhang lanes get training weight 0 so the
        # psum'd gradient equals the single-chip batch gradient exactly
        self._bs_g = n_train // cfg.train_batch_count
        self._bs_l = -(-self._bs_g // self.n)
        self._padded_train = (self._bs_g % self.n) != 0
        self.local_train = self._bs_l * cfg.train_batch_count

        axis = self.axis
        state_spec = NrcRenderState(
            image=P(axis), blend_index=P(), key=P(),
            ring=RingBuffer(data=P(axis), head=P(axis), tail=P(axis)),
            # NRC params/opt state replicated on every chip
            nrc=jax.tree.map(lambda _: P(), self._dummy_nrc()))
        self._state_spec = state_spec

        inner = partial(self._local_step, train=True)
        self._step_train = jax.jit(
            jax.shard_map(inner, mesh=self.mesh,
                          in_specs=(state_spec, P(), P(), P()),
                          out_specs=state_spec, check_vma=False),
            donate_argnums=(0,))
        inner_f = partial(self._local_step, train=False)
        self._step_frozen = jax.jit(
            jax.shard_map(inner_f, mesh=self.mesh,
                          in_specs=(state_spec, P(), P(), P()),
                          out_specs=state_spec, check_vma=False),
            donate_argnums=(0,))

    def _dummy_nrc(self):
        return jax.eval_shape(
            lambda k: self.cache.init_state(k), jax.random.PRNGKey(0))

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> NrcRenderState:
        key = jax.random.PRNGKey(seed)
        key, sub = jax.random.split(key)
        ring_cap = max(self.cfg.train_ring_size // self.n, 1)
        ring_data = np.zeros((self.n * ring_cap, 6), np.float32)
        ring_data[:, 3:] = 1.0 / np.sqrt(3.0)
        state = NrcRenderState(
            image=jnp.zeros((self.pad_h, self.width, 4), jnp.float32),
            blend_index=jnp.int32(1),
            ring=RingBuffer(
                data=jnp.asarray(ring_data),
                head=jnp.zeros((self.n,), jnp.int32),
                tail=jnp.zeros((self.n,), jnp.int32)),
            nrc=self.cache.init_state(sub),
            key=key)
        shardings = jax.tree.map(
            lambda s: NamedSharding(self.mesh, s), self._state_spec)
        return jax.device_put(state, shardings)

    def step(self, state: NrcRenderState, camera: Camera,
             train: bool = True) -> NrcRenderState:
        fn = self._step_train if train else self._step_frozen
        return fn(state, camera, self.vol, self.lights)

    def final_image(self, state: NrcRenderState) -> jax.Array:
        """The displayable image: padding rows (height not divisible by
        the mesh size) cropped off."""
        return state.image[:self.out_height]

    # ------------------------------------------------------------------
    def _local_step(self, state: NrcRenderState, camera: Camera, vol: Volume,
                    lights: Lights, *, train: bool) -> NrcRenderState:
        """Runs on ONE shard: local image rows + local train-pixel slice."""
        cfg = self.cfg
        axis = self.axis
        shard = jax.lax.axis_index(axis)
        row0 = shard * self.local_h

        # replicated frame seed: every shard derives the same stream so the
        # train-pixel re-trace below reproduces other shards' primaries
        key, sub = jax.random.split(state.key)
        frame_rand = rng.frame_random(sub)

        # ---- local primary rays ----
        x = jnp.arange(self.width, dtype=jnp.float32) * (1.0 / self.width)
        y = (jnp.arange(self.local_h, dtype=jnp.float32) + row0) \
            * (1.0 / self.height)
        uu, vv = jnp.meshgrid(x, y, indexing="xy")
        frag_uv = jnp.stack([uu, vv], axis=-1)
        rd = rays_for_uv(camera, frag_uv)
        rng_state = rng.init_state(frag_uv, frame_rand)
        n_local = self.local_h * self.width
        flat_rd = rd.reshape(n_local, 3)
        flat_ro = jnp.broadcast_to(camera.pos, flat_rd.shape)
        if cfg.compact:
            prim = primary_pass_compact(
                rng_state.reshape(n_local), vol, lights,
                self.primary_params, cfg, flat_ro, flat_rd,
                chunks=cfg.trace_chunks)
        else:
            prim = primary_pass(rng_state.reshape(n_local), vol, lights,
                                self.primary_params, cfg, flat_ro, flat_rd)

        x5 = pack_nrc_inputs(vol, prim["nrc_pos"], prim["nrc_dir"])
        # shard-local infer filter/compaction — same path as the
        # single-chip renderer (each shard compacts its own pixels)
        from ..renderer import infer_filtered
        nrc_rgb = infer_filtered(self.cache, cfg, state.nrc,
                                 x5.reshape(-1, 5),
                                 prim["did_scatter"].reshape(-1))
        prim = {k: v.reshape(self.local_h, self.width, *v.shape[1:])
                for k, v in prim.items() if k != "state"}
        nrc_rgb = nrc_rgb.reshape(self.local_h, self.width, 3)

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

        ring = ring_wrap(RingBuffer(data=state.ring.data,
                                    head=state.ring.head[0],
                                    tail=state.ring.tail[0]))
        nrc_state = state.nrc

        if train:
            # ---- local slice of the global train grid ----
            # Indexing preserves GLOBAL batch membership: local batch b
            # holds the shard's sub-range of global batch b, so the psum'd
            # gradient equals the single-chip batch gradient (same samples,
            # only reassociated).
            bs_g, bs_l = self._bs_g, self._bs_l
            j = jnp.arange(self.local_train)
            pos_in_batch = shard * bs_l + (j % bs_l)
            valid = pos_in_batch < bs_g
            lin = ((j // bs_l) * bs_g
                   + jnp.minimum(pos_in_batch, bs_g - 1))
            tyg = lin // self.train_w     # global train-grid coords
            txg = lin % self.train_w
            px = txg * self.train_x_dist  # global render-pixel coords
            py = tyg * self.train_y_dist

            # re-trace those pixels' primaries (bit-identical RNG streams)
            t_uv = jnp.stack(
                [px.astype(jnp.float32) / self.width,
                 py.astype(jnp.float32) / self.height], axis=-1)
            t_rd = rays_for_uv(camera, t_uv)
            t_ro = jnp.broadcast_to(camera.pos, t_rd.shape)
            t_rng = rng.init_state(t_uv, frame_rand)
            tprim = primary_pass(t_rng, vol, lights, self.primary_params,
                                 cfg, t_ro, t_rd)
            scat = tprim["did_scatter"]
            qpos = tprim["nrc_pos"]
            qdir = tprim["nrc_dir"]

            popped, ring = ring_pop(ring, ~scat & valid)
            r_ro = jnp.where(scat[..., None], qpos, popped[:, :3])
            r_rd = jnp.where(scat[..., None], qdir, popped[:, 3:])
            r_rd = r_rd / jnp.maximum(
                jnp.linalg.norm(r_rd, axis=-1, keepdims=True), 1e-12)

            # train-ray RNG: train-grid corner-subwindow UVs (quirk 7)
            s_uv = jnp.stack(
                [txg.astype(jnp.float32) / self.width,
                 tyg.astype(jnp.float32) / self.height], axis=-1)
            t_state = rng.init_state(s_uv, frame_rand)

            target = jnp.zeros_like(r_ro)
            for _ in range(cfg.train_spp):
                res = trace_fixed(t_state, vol, lights, self.params,
                                  r_ro, r_rd, cfg.train_ray_length)
                spp_rad = res["radiance"]
                if cfg.train_cache_bootstrap:
                    boot_x5 = pack_nrc_inputs(vol, res["terminal_pos"],
                                              res["terminal_dir"])
                    boot = jnp.maximum(
                        self.cache.infer(state.nrc, boot_x5), 0.0)
                    spp_rad = spp_rad + jnp.where(
                        res["alive"][..., None],
                        boot * res["throughput"][..., None], 0.0)
                target = target + spp_rad
                t_state = res["state"]
            target = jnp.minimum(target / cfg.train_spp,
                                 cfg.train_target_clamp)

            ring = ring_push(ring, scat & valid,
                             jnp.concatenate([r_ro, r_rd], axis=-1))

            train_x5 = pack_nrc_inputs(vol, r_ro, r_rd)
            # per-batch grads psum over the mesh: replicated params DP
            weight = valid.astype(jnp.float32) if self._padded_train \
                else None
            nrc_state = self.cache.train_frame(nrc_state, train_x5, target,
                                               axis_name=axis,
                                               weight=weight)

        ring_out = RingBuffer(data=ring.data, head=ring.head[None],
                              tail=ring.tail[None])
        return NrcRenderState(image=image, blend_index=blend_index,
                              ring=ring_out, nrc=nrc_state, key=key)
