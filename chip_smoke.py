"""Smoke test of the renderer on the GPU: the quickest proof that the
system starts and computes correctly on the card.

    python chip_smoke.py              # phases 1-4 on one GPU
    python chip_smoke.py --four-gpus  # phase 5 only: the sharded frame

Phases (each prints its own lines; any failure exits non-zero before the
result line):

1. Device: JAX must report a GPU; prints its kind and count and
   ``nvidia-smi --query-gpu=name,power.limit``.  Every time printed below
   carries that card line.
2. The main path — ``NrcRenderer.step`` at ``AppConfig()`` defaults (preset
   4, 1920x1080, 2^19-entry hash tables, 64x6 MLP, bf16 matmuls, 65,536
   train samples through 4 Adam+EMA steps) on the seeded stand-in cloud:
   compile + first online frame, 3 more online frames, 2 frozen frames,
   ``memory_analysis()`` of the compiled step.
   Checks: finite image, env colour 0.1 at the border, 4 optimizer steps
   per online frame, finite loss.
3. The same with 2^12-entry tables (the <= 2^16 training encode).
4. MC: one 1080p 32-bounce frame, and a 128x72 16-frame accumulation on
   the GPU and on the CPU from the same seed.
5. (--four-gpus) ``ShardedNrcRenderer`` over 4 GPUs at 1080p, one online
   and one frozen frame, against the single-GPU renderer from the same
   state and seed.

The renderers run XLA's own code only; there is no hand-written kernel
on this path (PERF.md records why).

The last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import dataclasses
import json
import sys
import time


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


class Clock:
    """Times a block that ends in block_until_ready; prints it with the
    card line."""

    def __init__(self, card):
        self.card = card

    def __call__(self, label, fn):
        import jax
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        dt = time.perf_counter() - t0
        print(f"  {label}: {dt * 1e3:.3f} ms [{self.card}]", flush=True)
        return out, dt


def phase_device(four):
    import jax

    from nrc_hpm.utils.device import card_lines, describe
    dev = describe()
    print(f"[1] device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    check(dev["platform"] == "gpu", "JAX found no GPU")
    if four:
        check(dev["count"] >= 4, f"--four-gpus needs 4 GPUs, "
              f"found {dev['count']}")
    lines = card_lines()
    for line in lines:
        print(f"  card: {line}", flush=True)
    del jax
    return dev, lines[0]


def event_interval_buffers(hlo_text):
    """(events, 32 intervals, lanes) arrays that the optimized program
    materialises — results of instructions outside fusion computations.
    transmittance._map_events builds such an indicator; fused into its
    reductions it never reaches device memory."""
    import re
    found, fused = [], False
    for line in hlo_text.splitlines():
        if line and not line[0].isspace():
            fused = "fused" in line.split("(")[0]
        elif not fused:
            m = re.search(r"= (pred|f32|s32)\[(\d+),32,(\d+)\]", line)
            if m and int(m.group(3)) >= 4096:
                found.append(m.group(0)[2:])
    return found


def nrc_phase(tag, cfg, vol, cam, seed, clock):
    """Online + frozen frames through NrcRenderer.step, with checks."""
    import jax
    import numpy as np

    from nrc_hpm.renderer import NrcRenderer

    r = NrcRenderer(cfg, vol=vol)
    state = r.init_state(seed)
    state, _ = clock("compile + first online frame",
                     lambda: r.step(state, cam, train=True))
    for i in range(3):
        state, _ = clock(f"online frame {i + 2}",
                         lambda: r.step(state, cam, train=True))
    for i in range(2):
        label = "frozen frame 1 (compile + run)" if i == 0 else \
            "frozen frame 2"
        state, _ = clock(label, lambda: r.step(state, cam, train=False))
    compiled = r._step_train.lower(state, cam, r.vol, r.lights).compile()
    print(f"  memory_analysis (online step): {compiled.memory_analysis()}",
          flush=True)
    big = event_interval_buffers(compiled.as_text())
    print(f"  (events, 32, lanes) buffers outside fusions: {len(big)} "
          f"{sorted(set(big))[:4]}", flush=True)

    img = np.asarray(state.image)
    check(img.shape == (cfg.render_height, cfg.render_width, 4),
          f"{tag}: image shape {img.shape}")
    check(np.isfinite(img).all(), f"{tag}: non-finite image")
    border = np.concatenate([img[0, :, :3], img[-1, :, :3],
                             img[:, 0, :3], img[:, -1, :3]])
    check(np.allclose(border, cfg.scene.hdr_env_map_strength, atol=1e-5),
          f"{tag}: border pixels are not the env colour "
          f"({border.min()}..{border.max()})")
    check(int(state.nrc.step) == 4 * cfg.train_batch_count,
          f"{tag}: nrc.step {int(state.nrc.step)} after 4 online frames")
    loss = float(state.nrc.loss)
    check(np.isfinite(loss), f"{tag}: loss {loss}")
    print(f"  checks ok: finite image, border = env "
          f"{cfg.scene.hdr_env_map_strength}, nrc.step "
          f"{int(state.nrc.step)}, loss {loss:.6f}", flush=True)
    del jax


def phase_mc(cfg, vol, cam, seed, clock):
    import jax
    import numpy as np

    from nrc_hpm.camera import Camera
    from nrc_hpm.lights import lights_from_scene
    from nrc_hpm.renderer import McRenderer

    mc = McRenderer(cfg, vol=vol)
    st, _ = clock("MC 1080p 32 bounces: compile + first frame",
                  lambda: mc.step(mc.init_state(seed), cam))
    st, _ = clock("MC 1080p 32 bounces: frame 2", lambda: mc.step(st, cam))
    img = np.asarray(st.image)
    check(np.isfinite(img).all(), "MC: non-finite image")

    small = dataclasses.replace(cfg, render_width=128, render_height=72)
    cam_s = Camera.reference_camera(aspect=128 / 72)
    gpu_img, _ = clock("MC 128x72 x16 frames on the GPU",
                       lambda: McRenderer(small, vol=vol).render(
                           cam_s, frames=16, seed=seed))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        vol_c = jax.device_put(vol, cpu)
        lights_c = jax.device_put(lights_from_scene(cfg.scene), cpu)
        cam_c = Camera.reference_camera(aspect=128 / 72)
        t0 = time.perf_counter()
        cpu_img = np.asarray(McRenderer(small, vol=vol_c, lights=lights_c)
                             .render(cam_c, frames=16, seed=seed))
        print(f"  MC 128x72 x16 frames on the CPU: "
              f"{time.perf_counter() - t0:.3f} s (host CPU)", flush=True)
    gpu_img = np.asarray(gpu_img)
    d = np.abs(gpu_img[..., :3] - cpu_img[..., :3]).max(axis=-1)
    close = float((d <= 1e-4 + 1e-3 * cpu_img[..., :3].max(-1)).mean())
    mean_rel = abs(gpu_img[..., :3].mean() / cpu_img[..., :3].mean() - 1.0)
    print(f"  GPU vs CPU: close-pixel share {close:.4f}, image-mean rel "
          f"diff {mean_rel:.3e}, max |d| {d.max():.3e}", flush=True)
    # The counter-based RNG gives both backends the same random numbers;
    # exp/log round differently in the last ulp, which now and then flips
    # one acceptance test and sends that path elsewhere.  Such flips are
    # rare and each touches one pixel's 1/16 share, so nearly all pixels
    # agree to float precision and the means agree closely.
    check(close >= 0.95, f"GPU/CPU MC close-pixel share {close:.4f}")
    check(mean_rel <= 0.01, f"GPU/CPU MC image means differ by {mean_rel}")
    return img


def phase_four(cfg, vol, cam, seed, clock):
    import concurrent.futures

    import numpy as np

    from nrc_hpm.parallel.sharding import ShardedNrcRenderer, make_mesh
    from nrc_hpm.renderer import NrcRenderer

    renderers = {"single GPU": NrcRenderer(cfg, vol=vol),
                 "4 GPUs": ShardedNrcRenderer(cfg, vol=vol,
                                              mesh=make_mesh(4))}
    # the renderers' own jitted steps, lowered here and compiled side by
    # side (XLA compiles on host threads; the four programs are independent)
    lowered = {}
    for name, r in renderers.items():
        st = r.init_state(seed)
        for train, fn in ((False, r._step_frozen), (True, r._step_train)):
            lowered[name, train] = fn.lower(st, cam, r.vol, r.lights)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        exes = dict(zip(lowered, pool.map(lambda lo: lo.compile(),
                                          lowered.values())))
    print(f"  compile of {len(exes)} steps (parallel): "
          f"{time.perf_counter() - t0:.3f} s [{clock.card}]", flush=True)

    out = {}
    for name, r in renderers.items():
        st0 = r.init_state(seed)
        w0 = np.asarray(st0.nrc.params["mlp"]["layers"][0]).copy()
        frozen, _ = clock(f"{name}: frozen frame", lambda: exes[
            name, False](r.init_state(seed), cam, r.vol, r.lights))
        online, _ = clock(f"{name}: online frame", lambda: exes[
            name, True](st0, cam, r.vol, r.lights))
        clock(f"{name}: online frame again", lambda: exes[name, True](
            r.init_state(seed), cam, r.vol, r.lights))
        img_f = np.asarray(frozen.image)[:cfg.render_height]
        img_o = np.asarray(online.image)[:cfg.render_height]
        w1 = np.asarray(online.nrc.params["mlp"]["layers"][0])
        out[name] = (img_f, img_o, w1 - w0, float(online.nrc.loss))
        check(np.isfinite(img_f).all() and np.isfinite(img_o).all(),
              f"{name}: non-finite image")
        check(int(online.nrc.step) == cfg.train_batch_count,
              f"{name}: nrc.step {int(online.nrc.step)}")
    (fa, oa, da, la), (fb, ob, db, lb) = out["single GPU"], out["4 GPUs"]
    # Same per-lane RNG streams; other batch shapes reassociate float
    # sums, which can flip a rare stochastic event — so compare as
    # tests/test_sharding.py does: nearly every pixel identical, means
    # preserved, and the first training update strongly correlated
    # (Adam's first steps are sign-like and amplify reassociation noise).
    for label, a, b in (("frozen", fa, fb), ("online", oa, ob)):
        same = float((np.abs(a - b).max(axis=-1) < 1e-4).mean())
        dmean = abs(float(a.mean()) - float(b.mean()))
        print(f"  {label} frame: identical-pixel share {same:.4f}, "
              f"mean diff {dmean:.3e}", flush=True)
        check(same > 0.97, f"{label}: sharded image differs")
        check(dmean < 5e-3, f"{label}: sharded image mean differs")
    corr = float(np.dot(da.ravel(), db.ravel())
                 / (np.linalg.norm(da) * np.linalg.norm(db)))
    print(f"  first-layer update correlation {corr:.4f}, loss single "
          f"{la:.6f} vs 4 GPUs {lb:.6f}", flush=True)
    check(corr > 0.95, f"sharded training update correlation {corr}")
    check(np.abs(da - db).max() < 5 * cfg.learning_rate
          * cfg.train_batch_count, "sharded weights drifted")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the 4-GPU sharded phase")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the cloud, the weights and the frames")
    args = p.parse_args(argv)

    dev, card = phase_device(args.four_gpus)

    from nrc_hpm.camera import Camera
    from nrc_hpm.config import AppConfig, EncodingConfig
    from nrc_hpm.utils.compile_cache import enable_compilation_cache
    from nrc_hpm.volume import seeded_volume

    enable_compilation_cache()
    clock = Clock(card)
    cfg = AppConfig()
    vol = seeded_volume(cfg.scene, args.seed)
    cam = Camera.reference_camera(aspect=cfg.render_width / cfg.render_height)

    if args.four_gpus:
        print("[5] 4 GPUs: ShardedNrcRenderer vs NrcRenderer at 1080p",
              flush=True)
        phase_four(cfg, vol, cam, args.seed, clock)
    else:
        print("[2] main path: AppConfig() at 1080p, 2^19 tables",
              flush=True)
        nrc_phase("2^19", cfg, vol, cam, args.seed, clock)
        print("[3] the same with 2^12 tables", flush=True)
        nrc_phase("2^12", dataclasses.replace(
            cfg, encoding=EncodingConfig(log2_hashmap_size=12)),
            vol, cam, args.seed, clock)

        print("[4] MC renderer", flush=True)
        img = phase_mc(cfg, vol, cam, args.seed, clock)
        print(f"  scatter fraction (1080p MC frame): "
              f"{float((img[..., 3] > 0.5).mean()):.4f} (infer "
              f"compaction capacity {cfg.infer_compact_frac})", flush=True)

    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
