import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrc_hpm.config import AppConfig, EncodingConfig
from nrc_hpm.models.nrc.cache import (NeuralRadianceCache, luminance,
                                          make_loss_fn, make_optimizer)
from nrc_hpm.models.nrc.mlp import init_mlp, mlp_apply


def _small_cfg(**kw):
    base = dict(nn_width=32, nn_depth=2,
                encoding=EncodingConfig(n_levels=4, log2_hashmap_size=12),
                log2_train_batch_size=6, train_batch_count=2)
    base.update(kw)
    return AppConfig(**base)


def test_mlp_shapes_and_no_bias():
    p = init_mlp(jax.random.PRNGKey(0), 48, 64, 6, 3)
    assert len(p["layers"]) == 7  # input + 5 hidden + output
    assert p["layers"][0].shape == (48, 64)
    assert p["layers"][-1].shape == (64, 3)
    x = jnp.zeros((8, 48))
    # bias-free: zero input -> zero output
    assert np.allclose(np.asarray(mlp_apply(p, x)), 0.0)


def test_mlp_bf16_close_to_f32():
    p = init_mlp(jax.random.PRNGKey(1), 16, 32, 2, 3)
    x = jax.random.normal(jax.random.PRNGKey(2), (64, 16))
    a = np.asarray(mlp_apply(p, x, jnp.float32))
    b = np.asarray(mlp_apply(p, x, jnp.bfloat16))
    assert np.abs(a - b).max() < 0.15 * max(1.0, np.abs(a).max())


def test_relative_l2_luminance_loss():
    fn = make_loss_fn("RelativeL2Luminance")
    pred = jnp.asarray([[1.0, 1.0, 1.0]])
    target = jnp.asarray([[0.0, 0.0, 0.0]])
    lum = 0.299 + 0.587 + 0.114  # = 1.0
    expect = 1.0 / (lum * lum + 0.01)
    assert float(fn(pred, target)) == pytest.approx(expect, rel=1e-5)


def test_loss_denominator_detached():
    fn = make_loss_fn("RelativeL2Luminance")
    pred = jnp.asarray([[0.5, 0.5, 0.5]])
    target = jnp.asarray([[0.2, 0.2, 0.2]])
    g = jax.grad(lambda p: fn(p, target))(pred)
    lum = float(luminance(pred[0]))
    # tcnn gradient: 2(pred-target)/(lum^2+0.01)/N with N = batch*3
    expect = 2 * 0.3 / (lum * lum + 0.01) / 3
    assert np.allclose(np.asarray(g)[0], expect, rtol=1e-5)


def test_unknown_loss_and_optimizer():
    with pytest.raises(ValueError):
        make_loss_fn("NotALoss")
    with pytest.raises(ValueError):
        make_optimizer("NotAnOpt", 0.01)


def test_cache_learns_constant_function():
    cfg = _small_cfg()
    cache = NeuralRadianceCache(cfg)
    state = cache.init_state(jax.random.PRNGKey(0))
    k = jax.random.PRNGKey(1)
    target_color = jnp.asarray([0.7, 0.2, 0.1])
    losses = []
    for i in range(400):
        k, sub = jax.random.split(k)
        x5 = jax.random.uniform(sub, (128, 5))
        target = jnp.broadcast_to(target_color, (128, 3))
        state = cache.train_step(state, x5, target)
        losses.append(float(state.loss))
    assert losses[-1] < 0.1 * (losses[0] + 1e-9) or losses[-1] < 1e-3
    # raw params converge; EMA(0.99) needs ~300 steps to catch up
    pred_raw = np.asarray(
        cache.apply(state.params, jax.random.uniform(k, (64, 5))))
    assert np.abs(pred_raw - np.asarray(target_color)).mean() < 0.05
    pred_ema = np.asarray(cache.infer(state, jax.random.uniform(k, (64, 5))))
    assert np.abs(pred_ema - np.asarray(target_color)).mean() < 0.1


def test_cache_learns_position_dependent_function():
    cfg = _small_cfg(learning_rate=0.01)
    cache = NeuralRadianceCache(cfg)
    state = cache.init_state(jax.random.PRNGKey(0))
    k = jax.random.PRNGKey(2)

    def truth(x5):
        return jnp.stack([x5[:, 0], x5[:, 1] * 0.5,
                          0.2 + 0.3 * x5[:, 2]], axis=-1)

    for i in range(300):
        k, sub = jax.random.split(k)
        x5 = jax.random.uniform(sub, (256, 5))
        state = cache.train_step(state, x5, truth(x5))
    k, sub = jax.random.split(k)
    x5 = jax.random.uniform(sub, (512, 5))
    pred = np.asarray(cache.apply(state.params, x5))
    err = np.abs(pred - np.asarray(truth(x5))).mean()
    assert err < 0.08, err


def test_ema_params_debiased_like_tcnn():
    """tcnn's EMA optimizer debiases (ema.h): step 1 serves the trained
    params exactly (the random init contributes nothing), and step 2
    serves the debiased weighted average of the two trained snapshots."""
    cfg = _small_cfg(ema_decay=0.99)
    cache = NeuralRadianceCache(cfg)
    state = cache.init_state(jax.random.PRNGKey(0))
    x5 = jax.random.uniform(jax.random.PRNGKey(1), (64, 5))
    tgt = jnp.ones((64, 3))
    s1 = cache.train_step(state, x5, tgt)
    w1 = np.asarray(s1.params["mlp"]["layers"][0])
    e1 = np.asarray(s1.ema_params["mlp"]["layers"][0])
    assert np.allclose(e1, w1, atol=1e-6)

    s2 = cache.train_step(s1, x5, tgt)
    w2 = np.asarray(s2.params["mlp"]["layers"][0])
    e2 = np.asarray(s2.ema_params["mlp"]["layers"][0])
    d = 0.99
    expect = (e1 * d * (1 - d) + w2 * (1 - d)) / (1 - d * d)
    assert not np.allclose(e2, w2)
    assert np.allclose(e2, expect, atol=1e-6)


def test_train_frame_runs_batch_count_steps():
    cfg = _small_cfg()  # 2 batches x 64
    cache = NeuralRadianceCache(cfg)
    state = cache.init_state(jax.random.PRNGKey(0))
    x5 = jax.random.uniform(jax.random.PRNGKey(1),
                            (cfg.train_pixel_count, 5))
    tgt = jnp.zeros((cfg.train_pixel_count, 3))
    s = cache.train_frame(state, x5, tgt)
    assert int(s.step) == 2
