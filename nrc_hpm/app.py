"""Application entry point — the reference's main loop, headless.

Replicates the experiment surface of src/main.cu:
- the 17 positional experiment args (or the built-in defaults when absent,
  main.cu:429-439), plus optional ``--flag`` overrides of this build;
- output/<configName>/ with log.txt benchmark lines and metrics.jsonl;
- per-frame: NRC render (+online training), optional MC render, golden
  comparison for both, NaN/Inf-loss abort (main.cu:380-384);
- EXR export of the accumulated images on exit and checkpointing of the
  trained cache (new capability).

The reference's ImGui/swapchain UI maps to structured logs.  It runs on
the GPU by default and exits non-zero when JAX finds none; run with
``--platform cpu`` for a quick functional pass on the CPU.

Usage:
  python -m nrc_hpm.app [17 positional args] [--frames N] [--width W]
      [--height H] [--renderer nrc|mc|both] [--benchmark-every K]
      [--platform gpu|cpu] [--mesh N] [--out DIR] [--checkpoint PATH]
      [--load-checkpoint PATH] [--export-exr]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="NRC-HPM renderer",
        usage=__doc__)
    p.add_argument("config_args", nargs="*",
                   help="the reference's 17 positional experiment args")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--renderer", choices=("nrc", "mc", "both", "restir"),
                   default="both")
    p.add_argument("--benchmark-every", type=int, default=1,
                   help="compare against the golden every K frames "
                        "(the reference benchmarks every frame)")
    p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard over N devices (0 = single chip)")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--checkpoint", default=None,
                   help="save the trained cache state here on exit")
    p.add_argument("--load-checkpoint", default=None)
    p.add_argument("--no-train", action="store_true",
                   help="frozen-cache rendering (BASELINE config 3)")
    p.add_argument("--export-exr", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="print the per-stage frame breakdown (the "
                        "reference's 8-query timestamp pool) before the run")
    p.add_argument("--compare-accumulated", action="store_true",
                   help="compare the accumulated on-screen image instead "
                        "of a fresh ref-camera frame (NOT the reference's "
                        "Reference::CompareNrc semantics; cheaper)")
    p.add_argument("--target-clamp", type=float, default=None,
                   help="train-target radiance clamp override "
                        "(reference parity: 8.0, prep_train_rays.comp:58)")
    p.add_argument("--log2-hashmap", type=int, default=0,
                   help="override the hash-grid table size (log2; "
                        "reference default 19)")
    p.add_argument("--n-levels", type=int, default=0,
                   help="override the hash-grid level count (default 16)")
    p.add_argument("--env-fixed16", action="store_true",
                   help="golden-era env transmittance: 16-step "
                        "GetTransmittance for the env in-scatter term, "
                        "matching how the upstream goldens were generated "
                        "(config.env_fixed16; path_trace.glsl:100)")
    p.add_argument("--cache-bootstrap", action="store_true",
                   help="terminate surviving train paths into the EMA "
                        "cache (config.train_cache_bootstrap; beyond-"
                        "reference bias reduction, default off)")
    p.add_argument("--seeded-cloud", type=int, default=None, metavar="SEED",
                   help="render volume.seeded_cloud(SEED) instead of the "
                        "scene's VDB (no golden comparison then)")
    p.add_argument("--camera-path", default=None,
                   help="JSON camera-path script replayed through the "
                        "reference's camera-controller semantics "
                        "(camera_path.py; Input.cpp:49-97)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    else:
        from .utils.device import require_gpu
        try:
            require_gpu()
        except SystemExit as e:
            print(f"--platform gpu: {e}; pass --platform cpu to run on the "
                  "CPU", file=sys.stderr)
            return 2

    from .utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()

    import jax.numpy as jnp
    import numpy as np

    from .camera import Camera
    from .config import DEFAULT_ARGV, AppConfig
    from .reference import GoldenReference
    from .renderer import McRenderer, NrcRenderer
    from .utils.metrics import RunLogger

    if args.config_args:
        cfg = AppConfig.from_argv(args.config_args)
    else:
        print("No arguments found. Loading defaults")
        cfg = AppConfig.from_argv(DEFAULT_ARGV)
    if args.log2_hashmap:
        cfg = dataclasses.replace(
            cfg, encoding=dataclasses.replace(
                cfg.encoding, log2_hashmap_size=args.log2_hashmap))
    if args.n_levels:
        cfg = dataclasses.replace(
            cfg, encoding=dataclasses.replace(cfg.encoding,
                                              n_levels=args.n_levels))
    if args.cache_bootstrap:
        cfg = dataclasses.replace(cfg, train_cache_bootstrap=True)
    if args.target_clamp is not None:
        cfg = dataclasses.replace(cfg, train_target_clamp=args.target_clamp)
    if args.env_fixed16:
        cfg = dataclasses.replace(cfg, env_fixed16=True)
    if args.width or args.height:
        cfg = dataclasses.replace(
            cfg, render_width=args.width or cfg.render_width,
            render_height=args.height or cfg.render_height)

    from .utils.device import card_lines, describe
    out_dir = args.out or os.path.join("output", cfg.name())
    logger = RunLogger(out_dir)
    # every time the run prints or logs goes with the card it ran on
    card = card_lines()[0] if args.platform == "gpu" else "host CPU"
    logger.event("device", card=card, jax_device=describe())
    print(f"device: {jax.devices()[0]}; card: {card}; output: {out_dir}")

    cam = Camera.reference_camera(
        aspect=cfg.render_width / cfg.render_height)
    cam_player = None
    if args.camera_path:
        from .camera_path import CameraPath
        cam_player = CameraPath.load(args.camera_path).player(
            cfg.render_width / cfg.render_height)
        cam = cam_player.camera

    vol = golden = None
    if args.seeded_cloud is not None:
        from .volume import seeded_volume
        vol = seeded_volume(cfg.scene, args.seeded_cloud)
        print(f"volume: seeded cloud {args.seeded_cloud}; golden "
              "comparisons disabled")
    else:
        try:
            golden = GoldenReference.load(cfg.scene.id)
        except FileNotFoundError:
            print(f"no golden image for scene {cfg.scene.id}; "
                  "comparisons disabled")

    # renderers -----------------------------------------------------------
    nrc_renderer = nrc_state = None
    mc_renderer = mc_state = None
    if args.renderer in ("nrc", "both"):
        if args.mesh:
            from .parallel.sharding import ShardedNrcRenderer, make_mesh
            nrc_renderer = ShardedNrcRenderer(cfg, vol=vol,
                                              mesh=make_mesh(args.mesh))
        else:
            nrc_renderer = NrcRenderer(cfg, vol=vol)
        nrc_state = nrc_renderer.init_state(0)
        if args.load_checkpoint:
            from .utils.checkpoint import load_pytree
            nrc_state = nrc_state.replace(
                nrc=load_pytree(args.load_checkpoint, nrc_state.nrc))
            print(f"loaded cache checkpoint {args.load_checkpoint}")
    if args.renderer in ("mc", "both"):
        mc_renderer = McRenderer(cfg, vol=vol)
        mc_state = mc_renderer.init_state(0)
    restir_renderer = restir_state = None
    if args.renderer == "restir":
        from .models.restir import RestirRenderer
        restir_renderer = RestirRenderer(cfg, vol=vol)
        restir_state = restir_renderer.init_state(0)

    if args.profile and nrc_renderer is not None and not args.mesh:
        from .profiler import format_stage_report, profile_nrc_frame
        stages = profile_nrc_frame(nrc_renderer, nrc_state, cam)
        print(format_stage_report(stages) + f"\n[{card}]", flush=True)
        logger.event("stage_profile", **{k: round(v, 3)
                                         for k, v in stages.items()})

    train = not args.no_train
    t_start = time.time()
    frame = -1
    last_t = time.time()
    for frame in range(args.frames):
        t0 = time.time()
        # HpmScene::Update (src/HpmScene.cpp:56-76, called per frame from
        # main.cu:269): dynamic scenes animate the dir light
        if cfg.scene.dynamic:
            from .lights import update_scene
            dt_s = t0 - last_t
            for r in (nrc_renderer, mc_renderer, restir_renderer):
                if r is not None:
                    r.lights = update_scene(r.lights, cfg.scene, dt_s)
        last_t = t0
        if cam_player is not None:
            # Input::HandleUserCamInput analog: a camera change restarts
            # the progressive accumulation (the reference's blend would
            # otherwise ghost; cam->SetChanged, Input.cpp:95)
            cam, cam_changed = cam_player.update(frame)
            if cam_changed:
                from .renderer import reset_accumulation
                if nrc_state is not None:
                    nrc_state = reset_accumulation(nrc_state)
                if mc_state is not None:
                    mc_state = reset_accumulation(mc_state)
                if restir_state is not None:
                    # ReSTIR keeps no blend accumulation; a camera cut
                    # invalidates the temporal-reuse history instead
                    restir_state = restir_state.replace(
                        old_reservoirs=jnp.zeros_like(
                            restir_state.old_reservoirs),
                        frame=jnp.int32(0))
        if nrc_renderer is not None:
            nrc_state = nrc_renderer.step(nrc_state, cam, train=train)
        if mc_renderer is not None:
            mc_state = mc_renderer.step(mc_state, cam)
        if restir_renderer is not None:
            restir_state = restir_renderer.step(restir_state, cam)
        if nrc_renderer is not None:
            jax.block_until_ready(nrc_state.image)
        if mc_renderer is not None:
            jax.block_until_ready(mc_state.image)
        if restir_renderer is not None:
            jax.block_until_ready(restir_state.image)
        frame_ms = (time.time() - t0) * 1000.0

        loss = float(nrc_state.nrc.loss) if nrc_renderer is not None else None
        nrc_cmp = mc_cmp = None
        if (golden is not None and args.benchmark_every > 0
                and frame % args.benchmark_every == 0):
            if args.compare_accumulated:
                # cheap mode: score the on-screen accumulation (valid while
                # the camera is static; NOT reference-comparable per frame)
                if nrc_renderer is not None:
                    from .reference import _renderer_image
                    nrc_cmp = golden.compare(
                        _renderer_image(nrc_renderer, nrc_state))
                if mc_renderer is not None:
                    mc_cmp = golden.compare(np.asarray(mc_state.image))
            else:
                # Reference::CompareNrc/CompareMc: one fresh frame with the
                # stored ref camera, accumulation cleared, training off
                # (Reference.cpp:72-154); our caller state is untouched
                if nrc_renderer is not None:
                    nrc_cmp = golden.compare_nrc(nrc_renderer, nrc_state)
                if mc_renderer is not None:
                    mc_cmp = golden.compare_mc(mc_renderer, mc_state)
        logger.frame(frame, frame_ms, loss=loss, nrc_cmp=nrc_cmp,
                     mc_cmp=mc_cmp)

        msg = f"frame {frame}: {frame_ms:.1f} ms [{card}]"
        if loss is not None:
            msg += f", loss {loss:.4f}"
        if nrc_cmp is not None:
            msg += (f", nrc mse {nrc_cmp.mse:.5f} relBias "
                    f"{nrc_cmp.rel_bias:+.4f} cv {nrc_cmp.cv:.3f}")
        if mc_cmp is not None:
            msg += f", mc mse {mc_cmp.mse:.5f}"
        print(msg, flush=True)

        # NaN/Inf loss abort (main.cu:380-384)
        if loss is not None and not math.isfinite(loss):
            print("Loss is NaN or Inf — aborting")
            break

    total = time.time() - t_start
    if frame >= 0 and total > 0:
        print(f"{frame + 1} frames in {total:.1f}s "
              f"({(frame + 1) / total:.2f} fps) [{card}]")

    if args.export_exr:
        from .utils.exr import write_exr
        if nrc_state is not None:
            from .reference import _renderer_image
            write_exr(os.path.join(out_dir, "nrc.exr"),
                      _renderer_image(nrc_renderer, nrc_state))
        if mc_state is not None:
            write_exr(os.path.join(out_dir, "mc.exr"),
                      np.asarray(mc_state.image))
        if restir_state is not None:
            write_exr(os.path.join(out_dir, "restir.exr"),
                      np.asarray(restir_state.image))
        print(f"exported EXRs to {out_dir}")

    if args.checkpoint and nrc_state is not None:
        from .utils.checkpoint import save_pytree
        save_pytree(args.checkpoint, nrc_state.nrc)
        print(f"saved cache checkpoint {args.checkpoint}")

    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
