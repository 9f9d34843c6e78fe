import jax.numpy as jnp
import numpy as np

from nrc_hpm.config import AppConfig, SceneConfig
from nrc_hpm.integrator import TraceParams, trace_fixed, trace_primary
from nrc_hpm.lights import (DirLight, HdrEnvMap, LightFlags, Lights,
                                PointLight)
from nrc_hpm.utils import rng
from nrc_hpm.volume import Volume


def _lights(dir_s=0.0, point_s=0.0, env_s=0.0):
    return Lights(
        dir_light=DirLight.create(strength=dir_s),
        point_light=PointLight.create(strength=point_s),
        env=HdrEnvMap.constant_white(env_s))


def _states(n):
    uv = jnp.stack([jnp.linspace(0, 1, n), jnp.linspace(0.3, 0.9, n)], -1)
    return rng.init_state(uv, jnp.asarray([0.15, 0.25, 0.35, 0.45]))


def test_no_lights_black():
    vol = Volume.homogeneous_cube(4, 1.0, 0.5, 0.0)
    lights = _lights()
    p = TraceParams(flags=LightFlags(False, False, False))
    n = 256
    ro = jnp.broadcast_to(jnp.asarray([-100.0, 0, 0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0, 0]), (n, 3))
    res = trace_fixed(_states(n), vol, lights, p, ro, rd, 8)
    assert np.allclose(np.asarray(res["radiance"]), 0.0)
    assert np.asarray(res["did_scatter"]).any()


def test_radiance_finite_and_nonnegative():
    vol = Volume.homogeneous_cube(8, 0.7, 0.6, 0.8)
    lights = _lights(dir_s=8.0, point_s=16.0, env_s=0.1)
    p = TraceParams(flags=LightFlags(True, True, True))
    n = 512
    ro = jnp.broadcast_to(jnp.asarray([-80.0, 1.0, 2.0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
    res = trace_fixed(_states(n), vol, lights, p, ro, rd, 8)
    rad = np.asarray(res["radiance"])
    assert np.isfinite(rad).all()
    assert (rad >= 0).all()
    assert rad.max() > 0


def test_throughput_halving():
    # factor = 0.5^n_scatters (gen_rays.comp:29)
    vol = Volume.homogeneous_cube(4, 1.0, 5.0, 0.0)  # dense: always scatter
    lights = _lights(env_s=1.0)
    p = TraceParams(flags=LightFlags(False, False, True))
    n = 64
    ro = jnp.broadcast_to(jnp.asarray([-100.0, 0, 0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0, 0]), (n, 3))
    res = trace_fixed(_states(n), vol, lights, p, ro, rd, 3)
    thr = np.asarray(res["throughput"])
    # every lane scatters at least once entering the dense slab, and the
    # factor is exactly 0.5^k for k in {1, 2, 3} (backscatter near the
    # entry face can exit after one or two bounces)
    assert set(np.unique(thr)).issubset({0.5, 0.25, 0.125})
    # most lanes survive all three bounces
    assert (thr == 0.125).mean() > 0.5


def test_primary_short_path_terminates():
    cfg = AppConfig(scene=SceneConfig.preset(1), primary_ray_length=1,
                    primary_ray_prob=0.0)
    vol = Volume.homogeneous_cube(4, 1.0, 5.0, 0.8)
    lights = _lights(point_s=64.0)
    p = TraceParams(flags=LightFlags(False, True, False))
    n = 128
    ro = jnp.broadcast_to(jnp.asarray([-100.0, 0, 0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0, 0]), (n, 3))
    res = trace_primary(_states(n), vol, lights, p, ro, rd, cfg)
    # prob=0: at most primary_ray_length+1 = 2 scatters -> factor >= 0.25
    assert (np.asarray(res["throughput"]) >= 0.25 - 1e-6).all()
    term = np.asarray(res["terminal_pos"])
    sky = np.asarray(vol.sky_size)
    scat = np.asarray(res["did_scatter"])
    assert scat.mean() > 0.95
    assert (np.abs(term[scat]) <= sky / 2 + 1e-3).all()


def test_deterministic_given_state():
    vol = Volume.homogeneous_cube(4, 0.8, 0.6, 0.8)
    lights = _lights(dir_s=8.0)
    p = TraceParams(flags=LightFlags(True, False, False))
    n = 64
    ro = jnp.broadcast_to(jnp.asarray([-60.0, 0, 0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0, 0]), (n, 3))
    r1 = trace_fixed(_states(n), vol, lights, p, ro, rd, 4)
    r2 = trace_fixed(_states(n), vol, lights, p, ro, rd, 4)
    assert np.allclose(np.asarray(r1["radiance"]), np.asarray(r2["radiance"]))


def test_single_scatter_point_light_oracle():
    """Analytic oracle for BASELINE config 1: homogeneous cube, point light
    at center, single-scatter (1 bounce), isotropic-ish phase.

    radiance = E[ T(light->x) * phase * strength ] with x the first
    collision. We brute-force the same estimator in NumPy with independent
    RNG and compare means.
    """
    sigma = 0.3
    vol = Volume.homogeneous_cube(4, 1.0, sigma, 0.0)
    sky = np.asarray(vol.sky_size)
    lights = _lights(point_s=64.0)
    p = TraceParams(flags=LightFlags(False, True, False))
    n = 60000
    ro = jnp.broadcast_to(jnp.asarray([-sky[0] / 2, 0, 0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0, 0]), (n, 3))
    res = trace_fixed(_states(n), vol, lights, p, ro, rd, 1)
    scat = np.asarray(res["did_scatter"])
    rad = np.asarray(res["radiance"])[..., 0]
    got = rad.mean()  # includes zero contribution of non-scattering lanes

    # NumPy oracle
    rs = np.random.RandomState(9)
    L = sky[0]
    t = rs.exponential(1 / sigma, n)
    hit = t < L
    x = -L / 2 + t[hit]
    dist_light = np.abs(x)  # light at origin, ray along x axis
    # transmittance estimated analytically (exact for homogeneous medium)
    trans = np.exp(-sigma * dist_light)
    phase = 0.5 * 1.0  # g=0: 0.5*(1-0)/1^{3/2}
    contrib = np.zeros(n)
    contrib[hit] = trans * 64.0 * phase * 0.5  # factor 0.5 after 1 scatter
    expect = contrib.mean()
    # ratio tracking at majorant density degenerates to a Bernoulli
    # transmittance estimate; the MC std of the mean here is ~2e-3, so
    # allow a 3-sigma band (both sides use fixed seeds: deterministic)
    assert abs(got - expect) < 0.006


def test_env_fixed16_flag_changes_env_term_only(small_volume):
    """env_fixed16 (golden-era env transmittance, TraceParams.env_fixed16):
    swaps the env in-scatter shadow estimator from ratio tracking to the
    16-step GetTransmittance the upstream goldens were generated with
    (path_trace.glsl:100, commented).  With only the env light enabled the
    flag must change the scene lighting; with env off it must be a no-op."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from nrc_hpm.integrator import TraceParams, trace_scene
    from nrc_hpm.lights import LightFlags, Lights, lights_from_scene
    from nrc_hpm.config import SceneConfig
    from nrc_hpm.utils import rng

    vol = small_volume
    lights = lights_from_scene(SceneConfig.preset(5))
    n = 64
    key = jax.random.PRNGKey(0)
    pos = jax.random.uniform(key, (n, 3), minval=-2.0, maxval=2.0)
    d = jax.random.normal(jax.random.PRNGKey(1), (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    state = rng.init_state(
        jax.random.uniform(jax.random.PRNGKey(2), (n, 2)),
        jnp.array([0.1, 0.2, 0.3, 0.4]))
    flags = LightFlags(dir_on=False, point_on=False, env_on=True)
    active = jnp.ones((n,), bool)

    p = TraceParams(flags=flags, max_track_steps=32)
    base, _ = trace_scene(state, vol, lights, p, pos, d, active)
    fixed, _ = trace_scene(state, vol, lights,
                           dataclasses.replace(p, env_fixed16=True),
                           pos, d, active)
    import numpy as np
    assert np.isfinite(np.asarray(fixed)).all()
    # same random env direction per lane, different transmittance estimator
    assert float(jnp.abs(base - fixed).max()) > 0.0

    flags_off = LightFlags(dir_on=True, point_on=False, env_on=False)
    p2 = TraceParams(flags=flags_off, max_track_steps=32)
    a, _ = trace_scene(state, vol, lights, p2, pos, d, active)
    b, _ = trace_scene(state, vol, lights,
                       dataclasses.replace(p2, env_fixed16=True),
                       pos, d, active)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_unrolled_primary_matches_while_loop(small_volume):
    """The unrolled short-primary loop (per-bounce capacities,
    integrator.trace_path round 5) must produce IDENTICAL values to the
    while-loop form: compaction capacities are value-transparent and the
    any-alive guard replicates the while's early exit.  Run above
    COMPACT_MIN_LANES so both compaction paths actually engage."""
    import dataclasses

    import jax

    from nrc_hpm.integrator import trace_path
    from nrc_hpm.lights import lights_from_scene

    vol = small_volume
    lights = lights_from_scene(SceneConfig.preset(4))
    n = 36864  # > COMPACT_MIN_LANES (32768)
    key = jax.random.PRNGKey(0)
    ro = jax.random.uniform(key, (n, 3), minval=-6.0, maxval=6.0)
    d = jax.random.normal(jax.random.PRNGKey(1), (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    state = rng.init_state(
        jax.random.uniform(jax.random.PRNGKey(2), (n, 2)),
        jnp.array([0.1, 0.2, 0.3, 0.4]))
    flags = LightFlags(dir_on=True, point_on=False, env_on=True)
    p = TraceParams(flags=flags, max_track_steps=32).primary_params()

    kw = dict(n_bounces=2, primary_ray_length=1, primary_ray_prob=0.0)
    rolled = trace_path(state, vol, lights, p, ro, d, unroll=False, **kw)
    unrolled = trace_path(state, vol, lights, p, ro, d, unroll=True, **kw)
    for k in ("radiance", "throughput", "did_scatter", "terminal_pos",
              "terminal_dir", "alive"):
        np.testing.assert_array_equal(
            np.asarray(rolled[k]), np.asarray(unrolled[k]), err_msg=k)
