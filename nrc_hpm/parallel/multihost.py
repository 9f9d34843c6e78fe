"""Multi-process execution support.

The reference is a single-GPU, single-process renderer (SURVEY §5 —
"no distributed anything"); this is new capability: the same
``ShardedNrcRenderer`` mesh spans processes (one per GPU host, or one per
GPU) once ``jax.distributed.initialize`` has run, with NRC gradients
psum'd across every device of the mesh.  Rays shard by image rows exactly as in the single-host case; every
per-shard computation is a pure function of (global coordinates, frame
seed), so no host ever needs another host's pixels — the only cross-host
traffic is the gradient allreduce.

Run one worker per process:

  python -m nrc_hpm.parallel.multihost --coordinator host0:9999 \
      --num-processes 2 --process-id 0 [--steps N] [--width W] ...

On CPU (tests), each process contributes
``--local-devices`` virtual devices via XLA_FLAGS; see
tests/test_multihost.py for the 2-process equivalence test.
"""

from __future__ import annotations

import argparse
import os
import sys


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_devices: int = 0) -> None:
    """jax.distributed.initialize with optional virtual CPU devices.
    Must run before any other JAX call in the process."""
    if local_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags +
                f" --xla_force_host_platform_device_count={local_devices}"
            ).strip()
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def put_global(tree, shardings):
    """device_put a host-global pytree onto (possibly multi-host)
    NamedShardings: every process holds the full value and contributes its
    addressable shards."""
    import jax
    try:
        return jax.device_put(tree, shardings)
    except ValueError:
        # older fallback: build arrays shard by shard
        import numpy as np

        def one(x, s):
            x = np.asarray(x)
            return jax.make_array_from_callback(
                x.shape, s, lambda idx: x[idx])
        return jax.tree.map(one, tree, shardings)


def run_worker(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--local-devices", type=int, default=0,
                   help="virtual CPU devices per process (0 = real devices)")
    p.add_argument("--platform", default=None, choices=(None, "cpu", "gpu"))
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--out", default=None,
                   help="process 0 writes the final gathered image (npy) "
                        "and a timing line here")
    args = p.parse_args(argv)

    if args.platform == "cpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    initialize(args.coordinator, args.num_processes, args.process_id,
               args.local_devices)

    import time

    import jax
    import numpy as np
    from jax.experimental import multihost_utils

    from ..camera import Camera
    from ..config import AppConfig, EncodingConfig
    from ..parallel.sharding import ShardedNrcRenderer, make_mesh
    from ..volume import seeded_volume

    cfg = AppConfig(
        render_width=args.width, render_height=args.height,
        encoding=EncodingConfig(log2_hashmap_size=14),
        log2_infer_batch_size=12, log2_train_batch_size=7,
        train_batch_count=2, mc_path_length=4, train_ray_length=4,
        max_track_steps=32)
    mesh = make_mesh()
    r = ShardedNrcRenderer(cfg, vol=seeded_volume(cfg.scene), mesh=mesh)
    cam = Camera.reference_camera(aspect=args.width / args.height)
    state = r.init_state(0)

    jax.block_until_ready(state.image)
    t0 = time.time()
    for _ in range(args.steps):
        state = r.step(state, cam, train=True)
    jax.block_until_ready(state.image)
    dt = (time.time() - t0) / max(args.steps, 1)

    img = multihost_utils.process_allgather(state.image, tiled=True)
    # the loss is replicated on every shard -> fully addressable locally
    loss = float(np.asarray(state.nrc.loss.addressable_data(0)))
    if jax.process_index() == 0:
        from ..utils.device import card_lines
        card = card_lines()[0] if jax.devices()[0].platform == "gpu" \
            else "host CPU"
        print(f"multihost: {jax.process_count()} processes, "
              f"{len(jax.devices())} devices, {dt*1e3:.1f} ms/step "
              f"[{card}], loss {loss:.4f}", flush=True)
        if args.out:
            np.save(args.out, np.asarray(img))
            with open(args.out + ".time", "w") as f:
                f.write(f"{dt}\n")
    return 0


if __name__ == "__main__":
    sys.exit(run_worker())
