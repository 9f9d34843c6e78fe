"""Benchmark: the online NRC frame at 1080p on one GPU; one JSON line.

Runs ``AppConfig()`` — preset 4, 1920x1080, 2^19-entry hash tables, 64x6
MLP, 65,536 train samples through 4 Adam+EMA steps — on the seeded
stand-in cloud (``volume.seeded_cloud(0)``), since the WDAS VDB is not
part of the repository.  Rows: the online frame (the headline), the
frozen-cache frame, NRC inference over the compacted and the full 1080p
batch, the 32-bounce MC frame and the online frame with 2^12 tables.
``NRC_BENCH_FULL=0`` keeps only the headline; ``NRC_BENCH_PROFILE=1`` adds
the per-stage breakdown (profiler.profile_nrc_frame).

Every time is the host clock around calls that end in
``jax.block_until_ready`` and is printed beside the card's name and power
limit.  Without a GPU the run exits non-zero.  All rows are also written
to output/bench_full.json.

    python bench.py
"""

import dataclasses
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _flag(name, default="1"):
    return os.environ.get(name, default).lower() not in ("", "0", "false")


def timed(step, n, state):
    """Seconds per call of ``state = step(state)`` over n calls, and the
    last state."""
    import jax
    t0 = time.perf_counter()
    for _ in range(n):
        state = step(state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / n, state


def main():
    import jax

    from nrc_hpm.camera import Camera
    from nrc_hpm.config import AppConfig, EncodingConfig
    from nrc_hpm.profiler import time_call
    from nrc_hpm.renderer import McRenderer, NrcRenderer
    from nrc_hpm.utils.compile_cache import enable_compilation_cache
    from nrc_hpm.utils.device import card_lines, require_gpu
    from nrc_hpm.volume import seeded_volume

    dev = require_gpu()
    card = card_lines()[0]
    cache_dir = enable_compilation_cache()
    log(f"device: {dev}; card: {card}; compilation cache: {cache_dir}")
    full = _flag("NRC_BENCH_FULL")
    results = {"device": dev, "card": card}

    cfg = AppConfig()
    vol = seeded_volume(cfg.scene)
    cam = Camera.reference_camera(aspect=cfg.render_width / cfg.render_height)
    n_rays = cfg.render_width * cfg.render_height

    def row(name, seconds, rays=n_rays):
        results[f"{name}_ms"] = seconds * 1e3
        results[f"{name}_rays_per_s"] = rays / seconds
        log(f"{name}: {seconds * 1e3:.3f} ms, {rays / seconds:.6e}/s "
            f"[{card}]")

    # ---- NRC online-training frame (the headline) ----
    r = NrcRenderer(cfg, vol=vol)
    state = r.init_state(0)
    t0 = time.perf_counter()
    state = jax.block_until_ready(r.step(state, cam, train=True))
    results["compile_plus_first_frame_s"] = time.perf_counter() - t0
    log(f"nrc compile+first frame: {results['compile_plus_first_frame_s']:.3f}"
        f" s [{card}]")
    dt, state = timed(lambda s: r.step(s, cam, train=True), 8, state)
    row("nrc_online", dt)
    results["nrc_loss"] = float(state.nrc.loss)

    if full:
        state = jax.block_until_ready(r.step(state, cam, train=False))
        dt, state = timed(lambda s: r.step(s, cam, train=False), 4, state)
        row("nrc_frozen", dt)

        # inference at the compaction capacity (~30% of 1080p) and over the
        # dense 2.07M-sample batch
        for name, n in (("nrc_infer", 622592),
                        ("nrc_infer_fullbatch", n_rays)):
            x5 = jax.random.uniform(jax.random.PRNGKey(1), (n, 5))
            row(name, time_call(r.cache.infer, (state.nrc, x5), 5), n)

        mc = McRenderer(cfg, vol=vol)
        mst = jax.block_until_ready(mc.step(mc.init_state(0), cam))
        dt, mst = timed(lambda s: mc.step(s, cam), 3, mst)
        row("mc32", dt)

        cfg12 = dataclasses.replace(
            cfg, encoding=EncodingConfig(log2_hashmap_size=12))
        r12 = NrcRenderer(cfg12, vol=vol)
        s12 = jax.block_until_ready(r12.step(r12.init_state(0), cam))
        dt, s12 = timed(lambda s: r12.step(s, cam, train=True), 3, s12)
        row("nrc_online_2e12", dt)

    if full and _flag("NRC_BENCH_PROFILE", default="0"):
        from nrc_hpm.profiler import format_stage_report, profile_nrc_frame
        stages = profile_nrc_frame(r, state, cam,
                                   total_ms=results["nrc_online_ms"])
        results["stages_ms"] = stages
        log(format_stage_report(stages) + f"\n[{card}]")

    os.makedirs("output", exist_ok=True)
    with open("output/bench_full.json", "w") as f:
        json.dump(results, f, indent=1)
    log("all rows written to output/bench_full.json")

    print(json.dumps({
        "metric": "nrc_online_rays_per_s_1080p",
        "value": results["nrc_online_rays_per_s"],
        "unit": "rays/s",
        "device": dev,
        "card": card,
    }))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
