import jax.numpy as jnp
import numpy as np

from nrc_hpm.transmittance import (delta_track, fixed_step_transmittance,
                                       ratio_track)
from nrc_hpm.volume import Volume, find_entry_exit


def _states(n, salt=0.123):
    from nrc_hpm.utils import rng
    uv = jnp.stack([jnp.linspace(0, 1, n), jnp.linspace(1, 0, n)], -1)
    return rng.init_state(uv, jnp.asarray([salt, 0.57, 0.31, 0.77]))


def test_fixed_step_homogeneous_analytic():
    vol = Volume.homogeneous_cube(4, 1.0, density_factor=0.5, g=0.0)
    sky = np.asarray(vol.sky_size)
    start = jnp.asarray([[-sky[0] / 2 + 0.1, 0, 0]], jnp.float32)
    end = jnp.asarray([[sky[0] / 2 - 0.1, 0, 0]], jnp.float32)
    L = float(sky[0] - 0.2)
    t = np.asarray(fixed_step_transmittance(vol, start, end, 64))[0]
    assert abs(t - np.exp(-0.5 * L)) < 0.02


def test_ratio_track_unbiased_homogeneous():
    # E[ratio-tracked T] == exp(-sigma L); with sigma == majorant every
    # sample multiplies (1 - 1) = 0 unless it escapes, so use a thinner
    # medium via the quantized grid value 128/255.
    vol = Volume.homogeneous_cube(4, 128.5 / 255, density_factor=0.8, g=0.0)
    sky = np.asarray(vol.sky_size)
    n = 20000
    start = jnp.broadcast_to(jnp.asarray([-sky[0] / 2 + 0.2, 0, 0]), (n, 3))
    end = jnp.broadcast_to(jnp.asarray([sky[0] / 2 - 0.2, 0, 0]), (n, 3))
    L = float(sky[0] - 0.4)
    sigma = 0.8 * 128 / 255
    t, _ = ratio_track(_states(n), vol, start, end)
    est = float(np.asarray(t).mean())
    expect = np.exp(-sigma * L)
    assert abs(est - expect) < 0.02 * max(expect, 0.02) + 0.005


def test_ratio_track_vacuum_is_one():
    vol = Volume.homogeneous_cube(4, 0.0, density_factor=0.6, g=0.0)
    n = 64
    start = jnp.zeros((n, 3), jnp.float32)
    end = jnp.broadcast_to(jnp.asarray([10.0, 0, 0]), (n, 3))
    t, _ = ratio_track(_states(n), vol, start, end)
    assert np.allclose(np.asarray(t), 1.0)


def test_delta_track_free_path_distribution():
    # Homogeneous: collision distance ~ Exp(sigma); P(exit) = exp(-sigma*L)
    vol = Volume.homogeneous_cube(4, 1.0, density_factor=0.15, g=0.0)
    sky = np.asarray(vol.sky_size)
    n = 40000
    ro = jnp.broadcast_to(jnp.asarray([-sky[0] / 2, 0.0, 0.0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
    pos, exited, _ = delta_track(_states(n), vol, ro, rd)
    exited = np.asarray(exited)
    L = float(sky[0])
    p_exit = np.exp(-0.15 * L)
    assert abs(exited.mean() - p_exit) < 0.01
    # collision points: distances ~ truncated Exp(0.15)
    dist = np.linalg.norm(np.asarray(pos) - np.asarray(ro), axis=-1)
    d = dist[~exited]
    # truncated exponential mean
    mean_trunc = (1 / 0.15) - L * p_exit / (1 - p_exit)
    assert abs(d.mean() - mean_trunc) < 0.3


def test_delta_track_vacuum_exits():
    vol = Volume.homogeneous_cube(4, 0.0, density_factor=0.6, g=0.0)
    n = 128
    ro = jnp.zeros((n, 3), jnp.float32)
    rd = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (n, 3))
    _, exited, _ = delta_track(_states(n), vol, ro, rd)
    assert np.asarray(exited).all()


def test_delta_track_collisions_inside_box(small_volume):
    n = 4096
    sky = np.asarray(small_volume.sky_size)
    ro = jnp.broadcast_to(jnp.asarray([-sky[0], 0.0, 0.0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
    pos, exited, _ = delta_track(_states(n), small_volume, ro, rd)
    pos = np.asarray(pos)[~np.asarray(exited)]
    assert (np.abs(pos) <= sky / 2 + 1e-3).all()


def test_rng_state_divergence_masked():
    # two identical lanes, one masked inactive -> state must not advance
    vol = Volume.homogeneous_cube(4, 1.0, 0.5, 0.0)
    ro = jnp.zeros((2, 3), jnp.float32)
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (2, 3))
    s0 = jnp.asarray([0.4, 0.4], jnp.float32)
    active = jnp.asarray([True, False])
    _, _, s1 = delta_track(s0, vol, ro, rd, active=active)
    assert np.asarray(s1)[1] == np.float32(0.4)
    assert np.asarray(s1)[0] != np.float32(0.4)


# ---------------------------------------------------------------------------
# fast (segment-vectorized) vs sequential tracking equivalence
# ---------------------------------------------------------------------------

def test_ratio_track_fast_matches_sequential_stats(small_volume):
    from nrc_hpm.transmittance import ratio_track_fast
    n = 20000
    sky = np.asarray(small_volume.sky_size)
    start = jnp.broadcast_to(jnp.asarray([-sky[0] / 2, 0, 0]), (n, 3))
    end = jnp.broadcast_to(jnp.asarray([sky[0] / 2, 1.0, 2.0]), (n, 3))
    t_seq, _ = ratio_track(_states(n), small_volume, start, end)
    t_fast, _ = ratio_track_fast(_states(n, 0.77), small_volume, start, end)
    a, b = float(np.mean(np.asarray(t_seq))), float(np.mean(np.asarray(t_fast)))
    assert abs(a - b) < 0.02, (a, b)


def test_delta_track_fast_matches_sequential_stats():
    from nrc_hpm.transmittance import delta_track_fast
    vol = Volume.homogeneous_cube(4, 1.0, density_factor=0.15, g=0.0)
    sky = np.asarray(vol.sky_size)
    n = 30000
    ro = jnp.broadcast_to(jnp.asarray([-sky[0] / 2, 0.0, 0.0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
    p1, e1, _ = delta_track(_states(n), vol, ro, rd)
    p2, e2, _ = delta_track_fast(_states(n, 0.9), vol, ro, rd)
    # same exit probability and same truncated free-path mean
    assert abs(np.asarray(e1).mean() - np.asarray(e2).mean()) < 0.015
    d1 = np.linalg.norm(np.asarray(p1) - np.asarray(ro), axis=-1)
    d2 = np.linalg.norm(np.asarray(p2) - np.asarray(ro), axis=-1)
    m1 = d1[~np.asarray(e1)].mean()
    m2 = d2[~np.asarray(e2)].mean()
    assert abs(m1 - m2) < 0.5, (m1, m2)


def test_fast_inactive_lanes_resolve_immediately():
    from nrc_hpm.transmittance import delta_track_fast, ratio_track_fast
    vol = Volume.homogeneous_cube(4, 1.0, 0.5, 0.0)
    ro = jnp.zeros((4, 3), jnp.float32)
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0, 0]), (4, 3))
    active = jnp.asarray([True, False, True, False])
    pos, exited, _ = delta_track_fast(
        jnp.full((4,), 0.3, jnp.float32), vol, ro, rd, active=active)
    assert np.isfinite(np.asarray(pos)).all()
    t, _ = ratio_track_fast(jnp.full((4,), 0.3, jnp.float32), vol, ro,
                            ro + rd * 50, active=active)
    # inactive lanes report transmittance 1 (no factors applied)
    assert np.asarray(t)[1] == 1.0 and np.asarray(t)[3] == 1.0


def test_fast_vacuum_behaviour():
    from nrc_hpm.transmittance import delta_track_fast, ratio_track_fast
    vol = Volume.homogeneous_cube(4, 0.0, 0.6, 0.0)
    n = 64
    ro = jnp.zeros((n, 3), jnp.float32)
    rd = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (n, 3))
    _, exited, _ = delta_track_fast(_states(n), vol, ro, rd)
    assert np.asarray(exited).all()
    t, _ = ratio_track_fast(_states(n), vol, ro, ro + rd * 10)
    assert np.allclose(np.asarray(t), 1.0)


# ---------------------------------------------------------------------------
# piecewise-majorant tracking equivalence
# ---------------------------------------------------------------------------

def test_ratio_track_pw_matches_sequential_stats(small_volume):
    from nrc_hpm.transmittance import ratio_track_pw
    n = 20000
    sky = np.asarray(small_volume.sky_size)
    start = jnp.broadcast_to(jnp.asarray([-sky[0] / 2, 0, 0]), (n, 3))
    end = jnp.broadcast_to(jnp.asarray([sky[0] / 2, 1.0, 2.0]), (n, 3))
    t_seq, _ = ratio_track(_states(n), small_volume, start, end)
    t_pw, _ = ratio_track_pw(_states(n, 0.51), small_volume, start, end)
    a = float(np.mean(np.asarray(t_seq)))
    b = float(np.mean(np.asarray(t_pw)))
    assert abs(a - b) < 0.02, (a, b)


def test_delta_track_pw_matches_sequential_stats(small_volume):
    from nrc_hpm.transmittance import delta_track_pw
    n = 30000
    sky = np.asarray(small_volume.sky_size)
    ro = jnp.broadcast_to(jnp.asarray([-sky[0], 0.5, 0.5]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
    p1, e1, _ = delta_track(_states(n), small_volume, ro, rd)
    p2, e2, _ = delta_track_pw(_states(n, 0.9), small_volume, ro, rd)
    assert abs(np.asarray(e1).mean() - np.asarray(e2).mean()) < 0.02
    d1 = np.linalg.norm(np.asarray(p1) - np.asarray(ro), axis=-1)
    d2 = np.linalg.norm(np.asarray(p2) - np.asarray(ro), axis=-1)
    m1 = d1[~np.asarray(e1)].mean()
    m2 = d2[~np.asarray(e2)].mean()
    assert abs(m1 - m2) < 0.5, (m1, m2)


def test_pw_empty_volume_zero_events():
    from nrc_hpm.transmittance import delta_track_pw, ratio_track_pw
    vol = Volume.homogeneous_cube(4, 0.0, 0.6, 0.0)
    n = 64
    ro = jnp.zeros((n, 3), jnp.float32)
    rd = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (n, 3))
    _, exited, _ = delta_track_pw(_states(n), vol, ro, rd)
    assert np.asarray(exited).all()
    t, _ = ratio_track_pw(_states(n), vol, ro, ro + rd * 30)
    assert np.allclose(np.asarray(t), 1.0)


def test_pw_homogeneous_exit_probability():
    from nrc_hpm.transmittance import delta_track_pw
    vol = Volume.homogeneous_cube(4, 1.0, 0.15, 0.0)
    sky = np.asarray(vol.sky_size)
    n = 40000
    ro = jnp.broadcast_to(jnp.asarray([-sky[0] / 2, 0.0, 0.0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
    _, exited, _ = delta_track_pw(_states(n), vol, ro, rd)
    p_exit = np.exp(-0.15 * float(sky[0]))
    assert abs(np.asarray(exited).mean() - p_exit) < 0.01


def test_pw_heterogeneous_transmittance_unbiased(seeded_grid):
    """Cloud chord: E[pw ratio-track] must equal the analytic Beer-Lambert
    transmittance of the quantized density line integral."""
    from nrc_hpm.transmittance import ratio_track_pw
    from nrc_hpm.volume import get_density
    vol = Volume.from_dense(seeded_grid, 0.6, 0.8)
    sky = np.asarray(vol.sky_size)
    n = 60000
    start = jnp.broadcast_to(jnp.asarray([-sky[0] / 2, -3.0, 5.0]), (n, 3))
    end = jnp.broadcast_to(jnp.asarray([sky[0] / 2, 2.0, -8.0]), (n, 3))
    t, _ = ratio_track_pw(_states(n), vol, start, end)
    est = float(np.asarray(t).mean())
    # dense quadrature of the optical depth along the same segment
    s = np.asarray(start)[0]
    e = np.asarray(end)[0]
    ts = np.linspace(0, 1, 20000, dtype=np.float32)
    pts = s + ts[:, None] * (e - s)
    dens = np.asarray(get_density(vol, jnp.asarray(pts)))
    od = dens.mean() * np.linalg.norm(e - s)
    expect = float(np.exp(-od))
    assert abs(est - expect) < 0.02, (est, expect)
