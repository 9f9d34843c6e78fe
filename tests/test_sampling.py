import jax.numpy as jnp
import numpy as np

from nrc_hpm.sampling import (dir_to_spherical_norm, hg_phase,
                                  new_ray_dir, sample_hg_cos_theta)
from nrc_hpm.utils import rng


def test_hg_phase_normalization():
    # Reference convention: integral over cos_theta in [-1,1] equals 1
    # (the azimuthal 1/2pi is baked into the 0.5 factor).
    for g in (0.0, 0.3, 0.8, -0.5):
        x = np.linspace(-1, 1, 20001)
        p = np.asarray(hg_phase(jnp.asarray(x), jnp.float32(g)))
        integral = np.trapz(p, x)
        assert abs(integral - 1.0) < 1e-3, g


def test_hg_sampling_matches_pdf():
    g = 0.8
    u = jnp.asarray(np.random.RandomState(0).rand(200000), jnp.float32)
    c = np.asarray(sample_hg_cos_theta(u, jnp.float32(g)))
    assert (c >= -1 - 1e-5).all() and (c <= 1 + 1e-5).all()
    # analytic mean of cos_theta for HG is g
    assert abs(c.mean() - g) < 0.01


def test_hg_sampling_isotropic_branch():
    u = jnp.asarray(np.linspace(0, 1, 1001)[:-1], jnp.float32)
    c = np.asarray(sample_hg_cos_theta(u, jnp.float32(0.0)))
    assert abs(c.mean()) < 2e-3  # half-open grid offsets the mean by 1/n
    assert abs(c.var() - 1 / 3) < 1e-2


def test_new_ray_dir_unit_and_hg_distributed():
    n = 100000
    state = rng.init_state(
        jnp.stack([jnp.linspace(0, 1, n), jnp.linspace(1, 0, n)], -1),
        jnp.asarray([0.11, 0.22, 0.33, 0.44]))
    old = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    d, _ = new_ray_dir(state, old, jnp.float32(0.8), phase_sampling=True)
    d = np.asarray(d)
    assert np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    cos = d[:, 2]
    # rotation is by ±theta, cos is unaffected by sign; mean(cos) == g
    assert abs(cos.mean() - 0.8) < 0.01


def test_new_ray_dir_azimuthal_symmetry():
    n = 50000
    state = jnp.asarray(np.random.RandomState(1).rand(n), jnp.float32)
    old = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    d, _ = new_ray_dir(state, old, jnp.float32(0.8), phase_sampling=True)
    d = np.asarray(d)
    assert abs(d[:, 0].mean()) < 0.01
    assert abs(d[:, 1].mean()) < 0.01


def test_new_ray_dir_degenerate_no_nan():
    # the reference would produce NaN for old_dir == (-1, 0, 0); we guard
    state = jnp.asarray([0.5, 0.5], jnp.float32)
    old = jnp.asarray([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], jnp.float32)
    d, _ = new_ray_dir(state, old, jnp.float32(0.8), phase_sampling=True)
    assert np.isfinite(np.asarray(d)).all()


def test_masked_lanes_keep_state():
    state = jnp.asarray([0.3, 0.7], jnp.float32)
    old = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (2, 3))
    active = jnp.asarray([True, False])
    _, s2 = new_ray_dir(state, old, jnp.float32(0.8), True, active=active)
    assert np.asarray(s2)[1] == 0.7
    assert np.asarray(s2)[0] != 0.3


def test_dir_to_spherical_in_range():
    rs = np.random.RandomState(7)
    d = rs.randn(1000, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tp = np.asarray(dir_to_spherical_norm(jnp.asarray(d)))
    assert np.isfinite(tp).all()
    # theta keeps the reference's convention (range [-0.5, 1.5]); phi is the
    # fixed elevation in [0, 1]
    assert (tp[:, 0] >= -0.5).all() and (tp[:, 0] <= 1.5).all()
    assert (tp[:, 1] >= 0).all() and (tp[:, 1] <= 1).all()
    # +X direction: theta = atan2(0, 1) = 0 -> 0.5; phi = acos(0) -> 0.5
    tp0 = np.asarray(dir_to_spherical_norm(jnp.asarray([[1.0, 0, 0]])))
    assert np.allclose(tp0, [[0.5, 0.5]], atol=1e-6)
