import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrc_hpm.config import EncodingConfig
from nrc_hpm.models.nrc.encoding import (CompositeEncoding, HashGridSpec,
                                             frequency_encode,
                                             hash_grid_encode, init_hash_grid,
                                             one_blob_encode,
                                             triangle_wave_encode)


def test_hashgrid_spec_matches_tcnn_layout():
    spec = HashGridSpec()  # reference defaults (AppConfig.cpp:19-27)
    # level 0: scale 15, res 16 (dense); level 3: res 128 -> hashed
    assert spec.level_resolution(0) == 16
    assert spec.level_resolution(1) == 32
    assert spec.level_is_dense(0) and spec.level_is_dense(2)
    assert not spec.level_is_dense(3)
    assert spec.level_params(0) == 16 ** 3
    assert spec.level_params(3) == spec.table_size
    assert spec.out_dim == 32
    # total: 3 dense + 13 hashed
    assert spec.total_params == 16**3 + 32**3 + 64**3 + 13 * spec.table_size


def test_hashgrid_interpolation_exact_at_vertices():
    spec = HashGridSpec(n_levels=1, n_features=2, log2_table_size=19,
                        base_resolution=16, per_level_scale=2.0)
    table = init_hash_grid(jax.random.PRNGKey(0), spec)
    # at grid vertex positions, the encoding equals the vertex feature:
    # pos*scale + 0.5 == integer k  =>  pos = (k - 0.5)/15
    k = 7
    pos = jnp.asarray([[(k - 0.5) / 15.0] * 3])
    out = hash_grid_encode(table, pos, spec)
    idx = k + 16 * k + 256 * k
    assert np.allclose(np.asarray(out)[0], np.asarray(table[idx]), atol=1e-7)


def test_hashgrid_continuity():
    spec = HashGridSpec(n_levels=4)
    table = init_hash_grid(jax.random.PRNGKey(1), spec)
    p = jnp.asarray([[0.3, 0.4, 0.5]])
    eps = 1e-5
    a = np.asarray(hash_grid_encode(table, p, spec))
    b = np.asarray(hash_grid_encode(table, p + eps, spec))
    assert np.abs(a - b).max() < 1e-3


def test_hashgrid_gradients_flow_to_table():
    spec = HashGridSpec(n_levels=2)
    table = init_hash_grid(jax.random.PRNGKey(2), spec)
    x = jax.random.uniform(jax.random.PRNGKey(3), (32, 3))

    def loss(t):
        return jnp.sum(hash_grid_encode(t, x, spec) ** 2)

    g = jax.grad(loss)(table)
    assert np.isfinite(np.asarray(g)).all()
    assert (np.asarray(g) != 0).any()


def test_hashgrid_out_of_range_no_nan():
    # the reference feeds out-of-[0,1] inputs (SURVEY quirk 2); encoding
    # must stay finite for e.g. theta in [-0.5, 1.5]
    spec = HashGridSpec(n_levels=4)
    table = init_hash_grid(jax.random.PRNGKey(4), spec)
    x = jnp.asarray([[-0.5, 1.5, 3.0], [100.0, -100.0, 0.5]])
    out = np.asarray(hash_grid_encode(table, x, spec))
    assert np.isfinite(out).all()


def test_one_blob_mass_and_peaks():
    x = jnp.asarray([[0.5, 0.25]])
    f = np.asarray(one_blob_encode(x, 4)).reshape(2, 4)
    # kernel mass inside [0,1]: Phi(2)-Phi(-2) ~ 0.954 at x=0.5, less near
    # the boundary (tails are truncated, matching the paper's formulation)
    assert 0.9 < f[0].sum() <= 1.0
    assert 0.8 < f[1].sum() <= 1.0
    # peak bin is the one containing x
    assert f[0].argmax() in (1, 2)  # x=.5 sits on the bin edge
    assert f[1].argmax() in (0, 1)  # x=.25 sits on the 0/1 bin edge
    # symmetric around x=0.5
    assert f[0, 0] == pytest.approx(f[0, 3], abs=1e-6)


def test_triangle_and_frequency_shapes():
    x = jnp.zeros((5, 3))
    assert triangle_wave_encode(x, 12).shape == (5, 36)
    assert frequency_encode(x, 12).shape == (5, 72)


def test_composite_default_dims():
    enc = CompositeEncoding(EncodingConfig())  # HashGrid + OneBlob
    assert enc.raw_dim == 32 + 8
    assert enc.out_dim == 48  # padded to multiple of 16
    params = enc.init_params(jax.random.PRNGKey(0))
    x5 = jax.random.uniform(jax.random.PRNGKey(1), (64, 5))
    out = np.asarray(enc(params, x5))
    assert out.shape == (64, 48)
    # padding features are ones (tcnn padding)
    assert np.allclose(out[:, 40:], 1.0)


def test_composite_identity_ids():
    enc = CompositeEncoding(EncodingConfig(pos_id=1, dir_id=1))
    assert enc.raw_dim == 5
    assert enc.out_dim == 16
    out = np.asarray(enc({}, jnp.ones((2, 5)) * 0.5))
    assert np.allclose(out[:, :5], 0.5)


def test_composite_invalid_ids():
    with pytest.raises(ValueError):
        CompositeEncoding(EncodingConfig(pos_id=9))
    with pytest.raises(ValueError):
        CompositeEncoding(EncodingConfig(dir_id=9))


def test_packed_encode_matches_f32():
    from nrc_hpm.models.nrc.encoding import (hash_grid_encode,
                                                 hash_grid_encode_packed,
                                                 pack_table_bf16)
    spec = HashGridSpec(n_levels=4, log2_table_size=12)
    table = init_hash_grid(jax.random.PRNGKey(0), spec) * 100  # O(1e-2)
    x = jax.random.uniform(jax.random.PRNGKey(1), (256, 3))
    a = np.asarray(hash_grid_encode(table, x, spec))
    b = np.asarray(hash_grid_encode_packed(pack_table_bf16(table), x, spec))
    # bf16 features: ~3 decimal digits
    assert np.abs(a - b).max() < 1e-2 * max(1.0, np.abs(a).max())
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999


def test_train_encode_forward_matches_packed():
    """hash_grid_encode_train forward == the bf16 packed-gather encode."""
    from nrc_hpm.models.nrc.encoding import (
        HashGridSpec, hash_grid_encode_packed, hash_grid_encode_train,
        init_hash_grid, pack_table_bf16)
    spec = HashGridSpec(n_levels=4, log2_table_size=10, base_resolution=4)
    key = jax.random.PRNGKey(0)
    table = init_hash_grid(key, spec) * 1e4  # O(1) features
    x = jax.random.uniform(jax.random.PRNGKey(1), (64, 3))
    out = hash_grid_encode_train(table, x, spec)
    ref = hash_grid_encode_packed(pack_table_bf16(table), x, spec)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-6)


def test_train_encode_backward_matches_autodiff():
    """The matmul-scatter backward must equal autodiff of the f32 encode
    up to bf16 forward rounding (the table gradient is linear in the
    upstream grad and independent of the stored values)."""
    from nrc_hpm.models.nrc.encoding import (
        HashGridSpec, hash_grid_encode, hash_grid_encode_train,
        init_hash_grid)
    spec = HashGridSpec(n_levels=4, log2_table_size=10, base_resolution=4)
    key = jax.random.PRNGKey(0)
    table = init_hash_grid(key, spec)
    x = jax.random.uniform(jax.random.PRNGKey(1), (128, 3))
    g = jax.random.normal(jax.random.PRNGKey(2),
                          (128, spec.out_dim), jnp.float32)

    def loss_fast(t):
        return jnp.vdot(hash_grid_encode_train(t, x, spec), g)

    def loss_ref(t):
        return jnp.vdot(hash_grid_encode(t, x, spec), g)

    d_fast = jax.grad(loss_fast)(table)
    d_ref = jax.grad(loss_ref)(table)
    np.testing.assert_allclose(np.asarray(d_fast), np.asarray(d_ref),
                               atol=5e-3, rtol=5e-3)


def test_hashgrid_backward_loop_oracle():
    """Autodiff table gradient vs an explicit loop over corners (slow
    trusted oracle): dL/dtable[e, f] = sum over (sample, corner) hits of
    w * g[sample, level, f]."""
    from nrc_hpm.models.nrc.encoding import (
        HashGridSpec, _corner_indices, hash_grid_encode, init_hash_grid)
    spec = HashGridSpec(n_levels=3, log2_table_size=8, base_resolution=4)
    key = jax.random.PRNGKey(3)
    table = init_hash_grid(key, spec)
    x = jax.random.uniform(jax.random.PRNGKey(4), (32, 3))
    g = jax.random.normal(jax.random.PRNGKey(5), (32, spec.out_dim))

    d_auto = jax.grad(
        lambda t: jnp.vdot(hash_grid_encode(t, x, spec), g))(table)

    idx, w = _corner_indices(x, spec)  # (N, L*8) flat, level-major
    idx, w = np.asarray(idx), np.asarray(w)
    gn = np.asarray(g).reshape(32, spec.n_levels, spec.n_features)
    d_loop = np.zeros(d_auto.shape, np.float64)
    for n in range(32):
        for l in range(spec.n_levels):
            for c in range(8):
                e = idx[n, l * 8 + c]
                for f in range(spec.n_features):
                    d_loop[e, f] += w[n, l * 8 + c] * gn[n, l, f]
    np.testing.assert_allclose(np.asarray(d_auto), d_loop, atol=1e-5)
