import jax.numpy as jnp
import numpy as np
import pytest

from nrc_hpm.volume import (Volume, find_entry_exit, get_density,
                                WORLD_SCALE)


def test_sky_size_normalized_extent(seeded_grid):
    vol = Volume.from_dense(seeded_grid, 0.6, 0.8)
    extent = np.array(seeded_grid.shape, np.float32)
    expect = extent / np.linalg.norm(extent) * WORLD_SCALE
    assert np.allclose(np.asarray(vol.sky_size), expect, atol=1e-4)


def test_density_nearest_matches_numpy(small_volume):
    vol = small_volume
    rs = np.random.RandomState(0)
    pos = (rs.rand(256, 3).astype(np.float32) - 0.5) * \
        np.asarray(vol.sky_size) * 1.2
    got = np.asarray(get_density(vol, jnp.asarray(pos)))
    sky = np.asarray(vol.sky_size)
    grid = np.asarray(vol.grid).astype(np.float32) / 255.0
    expect = np.zeros(len(pos), np.float32)
    for i, p in enumerate(pos):
        uvw = p / sky + 0.5
        if np.all((uvw >= 0) & (uvw < 1)):
            idx = np.floor(uvw * 8).astype(int)
            expect[i] = grid[tuple(idx)] * 0.6
    assert np.allclose(got, expect, atol=1e-6)


def test_density_outside_is_zero(small_volume):
    pos = jnp.asarray([[1e4, 0, 0], [0, -1e4, 0]], jnp.float32)
    assert np.all(np.asarray(get_density(small_volume, pos)) == 0)


def test_quantization_matches_reference(seeded_grid):
    # uint8(value * 255) truncation (Texture3D.cpp:105)
    vol = Volume.from_dense(seeded_grid, 1.0, 0.8)
    g = np.asarray(vol.grid)
    expect = (np.clip(seeded_grid, 0, 1) * 255).astype(np.uint8)
    assert (g == expect).all()


def test_entry_exit_outside_hit(cube_volume):
    vol = cube_volume
    sky = np.asarray(vol.sky_size)
    ro = jnp.asarray([[sky[0], 0.0, 0.0]], jnp.float32)
    rd = jnp.asarray([[-1.0, 0.0, 0.0]], jnp.float32)
    entry, exit_, hit = find_entry_exit(vol, ro, rd)
    assert bool(hit[0])
    assert np.allclose(np.asarray(entry)[0], [sky[0] / 2, 0, 0], atol=1e-4)
    assert np.allclose(np.asarray(exit_)[0], [-sky[0] / 2, 0, 0], atol=1e-4)


def test_entry_exit_inside(cube_volume):
    ro = jnp.zeros((1, 3), jnp.float32)
    rd = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    entry, exit_, hit = find_entry_exit(cube_volume, ro, rd)
    sky = np.asarray(cube_volume.sky_size)
    assert bool(hit[0])
    # inside the box: entry == ray origin (volume.glsl contract)
    assert np.allclose(np.asarray(entry)[0], [0, 0, 0], atol=1e-5)
    assert np.allclose(np.asarray(exit_)[0], [0, sky[1] / 2, 0], atol=1e-4)


def test_entry_exit_miss(cube_volume):
    sky = np.asarray(cube_volume.sky_size)
    ro = jnp.asarray([[sky[0] * 2, 0.0, 0.0]], jnp.float32)
    rd = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    _, _, hit = find_entry_exit(cube_volume, ro, rd)
    assert not bool(hit[0])


def test_entry_exit_vs_bruteforce(small_volume):
    rs = np.random.RandomState(3)
    sky = np.asarray(small_volume.sky_size)
    ro = (rs.rand(64, 3).astype(np.float32) - 0.5) * sky * 4
    rd = rs.randn(64, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    entry, exit_, hit = map(np.asarray, find_entry_exit(
        small_volume, jnp.asarray(ro), jnp.asarray(rd)))
    # brute-force march
    ts = np.linspace(0, np.linalg.norm(sky) * 4, 4000, dtype=np.float32)
    for i in range(64):
        pts = ro[i] + ts[:, None] * rd[i]
        inside = np.all(np.abs(pts) <= sky / 2 + 1e-4, axis=-1)
        if hit[i]:
            assert inside.any()
            t_in = ts[inside][0]
            t_out = ts[inside][-1]
            assert abs(np.linalg.norm(entry[i] - ro[i]) - t_in) < 0.2
            assert abs(np.linalg.norm(exit_[i] - ro[i]) - t_out) < 0.2
        else:
            # allow marginal grazing rays to disagree
            frac = inside.mean()
            assert frac < 0.02


def test_macro_majorant_dominates_density(seeded_grid):
    """The packed macro majorant must dominate the density everywhere and
    the control must stay below it, also when a grid dim is not a
    multiple of MACRO_CELL (the seeded cloud's 126 x 86 x 154): a point's
    macrocell is its voxel // 8."""
    from nrc_hpm.volume import get_density_xyz, macro_profile_xyz
    vol = Volume.from_dense(seeded_grid, 0.6, 0.8)
    sky = np.asarray(vol.sky_size)
    pts = (np.random.RandomState(0).rand(3, 200000) - 0.5) * sky[:, None]
    px, py, pz = (jnp.asarray(p, jnp.float32) for p in pts)
    dens = np.asarray(get_density_xyz(vol, px, py, pz))
    sig, ctl = map(np.asarray, macro_profile_xyz(vol, px, py, pz))
    assert (dens <= sig).all()
    assert (ctl <= dens).all()


def test_seeded_cloud_deterministic():
    from nrc_hpm.volume import seeded_cloud
    a, b, c = seeded_cloud(0), seeded_cloud(0), seeded_cloud(1)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_cloud_dims_range_occupancy(seed):
    from nrc_hpm.volume import seeded_cloud
    d = seeded_cloud(seed)
    assert d.shape == (126, 86, 154) and d.dtype == np.float32
    assert d.min() == 0.0 and d.max() == pytest.approx(1.0)
    # like the WDAS box: ~78% empty, after the u8 quantization too
    assert abs((d == 0).mean() - 0.78) < 0.01
    assert abs(((d * 255).astype(np.uint8) == 0).mean() - 0.78) < 0.02
    # heterogeneous interior, not a binary mask
    inside = d[d > 0]
    assert np.percentile(inside, 90) > 2 * np.percentile(inside, 10)
    assert seeded_cloud(seed, dims=(16, 8, 12)).shape == (16, 8, 12)
