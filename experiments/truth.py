"""Re-measure every hot primitive on the GPU: the piecewise event mapping
(binary search against the older membership form), raw gathers, NRC
inference and the density lookup at tracking shapes.  The ground truth for
optimisation decisions; the frame itself is measured by bench.py.

Times come from profiler.time_call and are printed with the card's name and
power limit.  Without a GPU it exits.

    python experiments/truth.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nrc_hpm.profiler import time_call  # noqa: E402
from nrc_hpm.utils.device import card_lines, require_gpu  # noqa: E402


def membership_map_events(E, cum, h, fields):
    """The pre-binary-search membership implementation, for comparison."""
    C = cum.shape[0]
    cum_left = jnp.concatenate([jnp.zeros_like(cum[:1]), cum[:-1]], axis=0)
    ge = E[:, None, :] >= cum_left[None]
    lt = E[:, None, :] < cum[None]
    ind = ge & lt
    beyond = E >= cum[-1][None, :]

    def sel(f):
        return jnp.sum(jnp.where(ind, f[None], 0.0), axis=1)

    t_left = jnp.arange(C, dtype=jnp.float32)[:, None] * h[None, :]
    rate = jnp.maximum((cum - cum_left) / jnp.maximum(h[None, :], 1e-20),
                       1e-12)
    t = sel(t_left) + (E - sel(cum_left)) / jnp.maximum(sel(rate), 1e-12)
    outs = [sel(f) for f in fields]
    return t, beyond, outs


def main():
    print("device:", require_gpu(), flush=True)
    card = card_lines()[0]

    def timeit(name, fn, *args, n=3):
        dt = time_call(fn, args, n)
        print(f"{name:<44s} {dt * 1e3:9.3f} ms [{card}]", flush=True)
        return dt

    from nrc_hpm.transmittance import _map_events

    for NL in (18,):
        N = 1 << NL
        tag = f"{N >> 10}K" if NL < 20 else f"{N >> 20}M"
        cum = jnp.cumsum(
            jax.random.uniform(jax.random.PRNGKey(0), (32, N)), axis=0)
        E = jax.random.uniform(jax.random.PRNGKey(1), (16, N)) * 20.0
        h = jnp.full((N,), 0.3)
        f = jnp.ones((32, N))
        n = 8 if NL <= 18 else 3
        timeit(f"map_events binsearch {tag}",
               lambda E, cum, h, f: _map_events(E, cum, h, (f, f))[0],
               E, cum, h, f, n=n)
        timeit(f"map_events membership {tag}",
               lambda E, cum, h, f: membership_map_events(
                   E, cum, h, (f, f))[0],
               E, cum, h, f, n=n)

    # raw gather rates
    tbl = jax.random.uniform(jax.random.PRNGKey(2), (7_100_000,))
    for shape, n in (((1 << 19, 128), 2), ((16, 1 << 21), 4),
                     ((1 << 21,), 8)):
        idx = jax.random.randint(jax.random.PRNGKey(3), shape, 0,
                                 tbl.shape[0])
        total = int(np.prod(shape))
        dt = timeit(f"take f32 {shape}",
                    lambda i, t: jnp.take(t, i, axis=0), idx, tbl, n=n)
        print(f"    -> {total / dt:.6e} elem/s", flush=True)

    # take_along_axis axis0 (the binary-search workhorse)
    src = jax.random.uniform(jax.random.PRNGKey(4), (32, 1 << 18))
    ii = jax.random.randint(jax.random.PRNGKey(5), (16, 1 << 18), 0, 32)
    timeit("take_along axis0 (16,256K)<-(32,256K)",
           lambda i, s: jnp.take_along_axis(s, i, axis=0), ii, src, n=8)

    # u8 vs f32 table gather
    tbl8 = (tbl * 255).astype(jnp.uint8)
    idx = jax.random.randint(jax.random.PRNGKey(3), (16, 1 << 21), 0,
                             tbl.shape[0])
    timeit("take u8 (16,2M)",
           lambda i, t: jnp.take(t, i, axis=0).astype(jnp.float32),
           idx, tbl8, n=4)

    # NRC infer
    from nrc_hpm.config import AppConfig
    from nrc_hpm.models.nrc.cache import NeuralRadianceCache
    cfg = AppConfig()
    cache = NeuralRadianceCache(cfg)
    st = jax.jit(cache.init_state)(jax.random.PRNGKey(0))
    x5s = jax.random.uniform(jax.random.PRNGKey(1), (1 << 19, 5))
    timeit("cache.infer 512K", lambda x, s: cache.infer(s, x), x5s, st,
           n=2)

    # density at tracking shapes
    from nrc_hpm.volume import get_density_xyz, seeded_volume
    vol = seeded_volume(cfg.scene)
    px = jax.random.uniform(jax.random.PRNGKey(6), (16, 1 << 21)) * 80 - 40
    py = jax.random.uniform(jax.random.PRNGKey(7), (16, 1 << 21)) * 80 - 40
    pz = jax.random.uniform(jax.random.PRNGKey(8), (16, 1 << 21)) * 80 - 40
    timeit("get_density_xyz (16,2M)",
           lambda px, py, pz: get_density_xyz(vol, px, py, pz),
           px, py, pz, n=3)


if __name__ == "__main__":
    main()
