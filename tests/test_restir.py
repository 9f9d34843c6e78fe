"""ReSTIR renderer tests (data/shader/restir/* made operational)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrc_hpm.camera import Camera
from nrc_hpm.config import AppConfig, RestirConfig, SceneConfig
from nrc_hpm.models.restir import (RestirRenderer, _local_init,
                                       _temporal_reuse, _shade)
from nrc_hpm.integrator import TraceParams
from nrc_hpm.lights import LightFlags, lights_from_scene
from nrc_hpm.utils import rng
from nrc_hpm.volume import seeded_volume


W, H = 48, 32


@pytest.fixture(scope="module")
def renderer():
    cfg = AppConfig(
        scene=SceneConfig.preset(4), render_width=W, render_height=H,
        restir=RestirConfig(path_vertex_count=4, spatial_kernel_size=3,
                            temporal_kernel_size=2))
    return RestirRenderer(cfg, vol=seeded_volume(cfg.scene))


def test_restir_frame_basics(renderer):
    cam = Camera.reference_camera(aspect=W / H)
    img = np.asarray(renderer.render(cam, frames=2))
    assert img.shape == (H, W, 4)
    assert np.isfinite(img).all()
    # border rays miss the box -> background env color (scene 4 strength)
    assert img[0, 0, 0] == pytest.approx(0.1, abs=1e-5)
    # alpha channel is the path transmittance in [0, 1]
    assert (img[..., 3] >= 0).all() and (img[..., 3] <= 1).all()


def test_restir_state_evolves(renderer):
    cam = Camera.reference_camera(aspect=W / H)
    st = renderer.init_state(0)
    st1 = renderer.step(st, cam)
    frame1 = int(st1.frame)  # read before st1 is donated to the next step
    st2 = renderer.step(st1, cam)
    assert frame1 == 1 and int(st2.frame) == 2
    scat = np.asarray(st2.pixel_info[..., 3])
    assert set(np.unique(scat)) <= {0.0, 1.0}
    assert scat.sum() > 0  # something scatters in the cloud
    # scattered pixels advanced their RIS stream past the init value 1
    stream = np.asarray(st2.stats[..., 0])
    v = renderer.n_vertices
    t = renderer.temporal_kernel
    expected_min = 1 + t * (v - 1)  # temporal candidates always examined
    assert (stream[scat == 1.0] >= expected_min).all()
    # non-scattered pixels never advance the stream
    assert (stream[scat == 0.0] == 1.0).all()


def test_restir_miss_pixels_keep_reservoir(renderer):
    """local_init leaves the reservoir untouched for rays that miss the
    volume box (the shader returns before GenPath)."""
    n = 6
    # rays starting outside the box, pointing away: guaranteed miss
    ro = jnp.broadcast_to(jnp.asarray([500.0, 0.0, 0.0]), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
    prev = jnp.full((n, renderer.n_vertices, 6), 7.5)
    rs = rng.init_state(jnp.zeros((n, 2)), jnp.ones((4,)))
    res, info, stats, _ = _local_init(rs, renderer.vol, renderer.lights,
                                      ro, rd, prev, renderer.n_vertices)
    np.testing.assert_array_equal(np.asarray(res), 7.5)
    assert (np.asarray(info[..., 3]) == 0.0).all()
    # stats reset to stream=1, exchange=0 (local_init.comp:86-87)
    np.testing.assert_array_equal(np.asarray(stats[..., 0]), 1.0)
    np.testing.assert_array_equal(np.asarray(stats[..., 1]), 0.0)


def test_restir_exchange_vertex_in_range(renderer):
    cam = Camera.reference_camera(aspect=W / H)
    st = renderer.init_state(1)
    for _ in range(3):
        st = renderer.step(st, cam)
    ex = np.asarray(st.stats[..., 1])
    assert (ex >= 0).all() and (ex < renderer.n_vertices).all()


def test_restir_vertices_inside_box(renderer):
    """Path vertices of scattered pixels stay in world space near the box
    (entry + bounded random-walk steps)."""
    cam = Camera.reference_camera(aspect=W / H)
    st = renderer.init_state(0)
    st = renderer.step(st, cam)
    scat = np.asarray(st.pixel_info[..., 3]) == 1.0
    pos = np.asarray(st.reservoir[..., :3])[scat]
    sky = np.asarray(renderer.vol.sky_size)
    assert (np.abs(pos) <= sky * 1.5 + 1e-3).all()


def test_shade_background_passthrough():
    """Pixels that shade nothing return the stored background color."""
    cfg = AppConfig(scene=SceneConfig.preset(4), render_width=8,
                    render_height=8,
                    restir=RestirConfig(path_vertex_count=3))
    r = RestirRenderer(cfg, vol=seeded_volume(cfg.scene))
    st = r.init_state(0)
    # hand-build: no pixel scattered, background = 0.25
    pixel_info = jnp.concatenate(
        [jnp.full((8, 8, 3), 0.25), jnp.zeros((8, 8, 1))], axis=-1)
    params = TraceParams(flags=LightFlags.from_scene(cfg.scene))
    rs = rng.init_state(jnp.zeros((8, 8, 2)), jnp.ones((4,)))
    img, _ = _shade(rs, r.vol, r.lights, params, st.reservoir, st.stats,
                    pixel_info, 3)
    np.testing.assert_allclose(np.asarray(img[..., :3]), 0.25)
    np.testing.assert_allclose(np.asarray(img[..., 3]), 1.0)


def test_temporal_reuse_noop_on_frame0():
    """Frame 0 has no history: reservoirs must pass through unchanged."""
    h, w, v, t = 4, 4, 3, 2
    res = jax.random.uniform(jax.random.PRNGKey(0), (h, w, v, 6))
    old = jnp.zeros((t, h, w, v, 6))
    stats = jnp.stack([jnp.ones((h, w)), jnp.zeros((h, w))], axis=-1)
    info = jnp.concatenate(
        [jnp.zeros((h, w, 3)), jnp.ones((h, w, 1))], axis=-1)
    rs = rng.init_state(jnp.zeros((h, w, 2)), jnp.ones((4,)))
    mis = jnp.zeros((h, w, 2))
    out_res, out_old, out_stats, _, _ = _temporal_reuse(
        rs, res, old, stats, mis, info, jnp.int32(0), v, t)
    np.testing.assert_array_equal(np.asarray(out_res), np.asarray(res))
    np.testing.assert_array_equal(np.asarray(out_old), np.asarray(old))
    # the stream still advanced for scattered pixels
    assert (np.asarray(out_stats[..., 0]) == 1 + t * (v - 1)).all()


def test_restir_config_defaults():
    cfg = AppConfig()
    assert cfg.restir.path_vertex_count == 8
    assert cfg.restir.spatial_kernel_size == 3
    assert cfg.restir.temporal_kernel_size == 2
    assert cfg.restir.mis_weights is True


def test_uniform_weights_make_wsum_equal_stream():
    """weighted=False must reproduce the shader's uniform 1/stream scheme:
    every examined candidate contributes weight 1, so wsum == stream - 1
    and the RIS contribution weight in _shade is exactly 1."""
    h, w, v, t = 4, 4, 3, 2
    res = jax.random.uniform(jax.random.PRNGKey(3), (h, w, v, 6))
    old = jax.random.uniform(jax.random.PRNGKey(4), (t, h, w, v, 6))
    stats = jnp.stack([jnp.ones((h, w)), jnp.zeros((h, w))], axis=-1)
    mis = jnp.zeros((h, w, 2))
    info = jnp.concatenate(
        [jnp.zeros((h, w, 3)), jnp.ones((h, w, 1))], axis=-1)
    rs = rng.init_state(jnp.zeros((h, w, 2)), jnp.ones((4,)))
    _, _, out_stats, out_mis, _ = _temporal_reuse(
        rs, res, old, stats, mis, info, jnp.int32(5), v, t,
        g=0.8, weighted=False)
    np.testing.assert_allclose(np.asarray(out_mis[..., 0]),
                               np.asarray(out_stats[..., 0]) - 1.0)
    # selected candidates carry weight exactly 1
    w_sel = np.asarray(out_mis[..., 1])
    assert set(np.unique(w_sel)) <= {0.0, 1.0}


def test_weighted_selection_prefers_high_phase_candidate():
    """With mis_weights the stream is weighted RIS: a candidate whose
    reconnection factor dwarfs the others must win the stream (w-ratio
    ~((1+g)/(1-g))^3 ~ 7000 at g=0.9)."""
    h, w, v, t = 2, 2, 3, 2
    # own path marches along +x: vertices (0,0,0), (1,0,0), (2,0,0)
    own = jnp.zeros((h, w, v, 6))
    own = own.at[..., 1, 0].set(1.0).at[..., 2, 0].set(2.0)
    # slot for t=0 at frame=4 (even): mod(4-1, 2) = 1; t=1 -> slot 0
    old = jnp.zeros((t, h, w, v, 6))
    # candidate (t=0, v=2): q so conn = -last_dir (dot = +1, max weight)
    old = old.at[1, ..., 2, 0].set(0.0)   # q=(0,0,0), r=own[1]=(1,0,0)
    # candidate (t=1, v=2): forward conn = +last_dir (dot = -1, tiny)
    old = old.at[0, ..., 2, 0].set(3.0)
    stats = jnp.stack([jnp.ones((h, w)), jnp.zeros((h, w))], axis=-1)
    mis = jnp.zeros((h, w, 2))
    info = jnp.concatenate(
        [jnp.zeros((h, w, 3)), jnp.ones((h, w, 1))], axis=-1)
    rs = rng.init_state(
        jnp.stack(jnp.meshgrid(jnp.linspace(0, 1, w),
                               jnp.linspace(0, 1, h)), axis=-1),
        jnp.asarray([0.3, 0.7, 0.1, 0.9]))
    out_res, _, out_stats, out_mis, _ = _temporal_reuse(
        rs, own, old, stats, mis, info, jnp.int32(4), v, t,
        g=jnp.float32(0.9), weighted=True)
    # every pixel must have selected the (t=0, v=2) splice: exchange == 2
    # and the spliced vertex-2 position is the high-weight q == 0
    np.testing.assert_array_equal(np.asarray(out_stats[..., 1]), 2.0)
    np.testing.assert_allclose(np.asarray(out_res[..., 2, 0]), 0.0)
    # the recorded w_sel is the dominant weight (hg_phase(+1) at g=0.9)
    from nrc_hpm.sampling import hg_phase
    np.testing.assert_allclose(
        np.asarray(out_mis[..., 1]),
        float(hg_phase(jnp.float32(1.0), jnp.float32(0.9))), rtol=1e-5)


def test_ris_contribution_weight_scales_suffix():
    """_shade applies W = wsum/(M * w_sel) at the exchange vertex: with
    wsum == M * w_sel the image equals the no-mis shading; doubling wsum
    doubles only the spliced-suffix contribution."""
    cfg = AppConfig(scene=SceneConfig.preset(4), render_width=24,
                    render_height=24,
                    restir=RestirConfig(path_vertex_count=3))
    r = RestirRenderer(cfg, vol=seeded_volume(cfg.scene))
    cam = Camera.reference_camera(aspect=1.0)
    st = r.init_state(0)
    st = r.step(st, cam)   # real reservoirs/paths
    params = TraceParams(flags=LightFlags.from_scene(cfg.scene))
    rs = rng.init_state(jnp.zeros((24, 24, 2)), jnp.ones((4,)))
    # force exchange = 1 everywhere so the factor applies
    stats = jnp.stack([jnp.full((24, 24), 5.0), jnp.ones((24, 24))], axis=-1)
    m = 4.0
    mis_neutral = jnp.stack([jnp.full((24, 24), m * 2.0),
                             jnp.full((24, 24), 2.0)], axis=-1)
    mis_double = jnp.stack([jnp.full((24, 24), 2 * m * 2.0),
                            jnp.full((24, 24), 2.0)], axis=-1)
    img_none, _ = _shade(rs, r.vol, r.lights, params, st.reservoir,
                         stats, st.pixel_info, 3, mis=None)
    img_neutral, _ = _shade(rs, r.vol, r.lights, params, st.reservoir,
                            stats, st.pixel_info, 3, mis=mis_neutral)
    img_double, _ = _shade(rs, r.vol, r.lights, params, st.reservoir,
                           stats, st.pixel_info, 3, mis=mis_double)
    np.testing.assert_allclose(np.asarray(img_neutral),
                               np.asarray(img_none), rtol=1e-6)
    # doubling W scales the (suffix) radiance up, never down
    a = np.asarray(img_neutral[..., :3])
    b = np.asarray(img_double[..., :3])
    assert (b >= a - 1e-6).all() and b.sum() > a.sum()


def test_restir_statistically_matches_mc_structure():
    """Image-level validation vs the MC ground truth on the same scene
    (VERDICT r1 item 7).  The reference's ReSTIR is dead code with no
    published output contract, so the gate is statistical: the shaded
    reservoir image must (a) see the same cloud silhouette (its scatter
    mask must overlap MC's), (b) land within a loose brightness band of
    the MC mean over scattered pixels, and (c) correlate spatially with
    the MC image."""
    import dataclasses

    from nrc_hpm.camera import Camera
    from nrc_hpm.config import AppConfig, SceneConfig
    from nrc_hpm.models.restir import RestirRenderer
    from nrc_hpm.renderer import McRenderer

    W, H = 64, 36
    cfg = dataclasses.replace(
        AppConfig(scene=SceneConfig.preset(0)),
        render_width=W, render_height=H, mc_path_length=8,
        max_track_steps=64)
    cam = Camera.reference_camera(aspect=W / H)

    mc = McRenderer(cfg, vol=seeded_volume(cfg.scene))
    mc_img = np.asarray(mc.render(cam, frames=24, seed=1))

    rs = RestirRenderer(cfg, vol=seeded_volume(cfg.scene))
    state = rs.init_state(2)
    acc = np.zeros((H, W, 4), np.float64)
    frames = 12
    for _ in range(frames):
        state = rs.step(state, cam)
        acc += np.asarray(state.image)
    restir_img = (acc / frames).astype(np.float32)

    mc_scat = mc_img[..., 3] > 0.5
    # ReSTIR pixel_info.w is its didScatter analog; use image alpha if set,
    # else brightness mask
    r_mask = restir_img[..., :3].sum(-1) > 1e-6
    overlap = (mc_scat & r_mask).sum() / max(mc_scat.sum(), 1)
    assert overlap > 0.6, f"silhouette overlap {overlap:.2f}"

    mc_mean = mc_img[..., :3][mc_scat].mean()
    rs_mean = restir_img[..., :3][mc_scat].mean()
    assert 0.2 * mc_mean < rs_mean < 5.0 * mc_mean, (mc_mean, rs_mean)

    # correlate 4x4-pooled luminance (pooling suppresses the per-pixel MC
    # noise so the comparison is about structure, not sample variance)
    def pool(img):
        lum = img[..., :3].mean(-1)
        return lum.reshape(H // 4, 4, W // 4, 4).mean((1, 3)).ravel()

    corr = np.corrcoef(pool(mc_img), pool(restir_img))[0, 1]
    assert corr > 0.5, f"pooled spatial correlation {corr:.3f}"
