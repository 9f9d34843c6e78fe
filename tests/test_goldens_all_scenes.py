"""Cross-scene quality net against the checked-in low-res goldens.

``reference/<id>/low.exr`` are 192x108 goldens of 256 accumulated
64-bounce MC frames (1024 for scene 3's canonical ``reference/3/0.exr``),
generated from the WDAS cloud by experiments/make_goldens.py
through reference.generate_golden — the working form of the reference's
dead GenRefImages branch (Reference.cpp:566-671, SURVEY quirk 3).  Scene 3
additionally gets ``reference/3/0.exr`` (the upstream repo never shipped
one).

Each preset gets a short CPU MC run compared via the reference's
comparator semantics: mean brightness must land within a few percent
(32-bounce truncation + accumulation noise set the tolerance).  All six
presets share one compiled program (identical shapes), so the suite pays
one compile.
"""
import os

import numpy as np
import pytest

from nrc_hpm.camera import Camera
from nrc_hpm.config import AppConfig, SceneConfig
from nrc_hpm.reference import GoldenReference
from nrc_hpm.renderer import McRenderer
from nrc_hpm.volume import Volume

W, H, FRAMES = 96, 54, 10

pytestmark = pytest.mark.skipif(
    not os.path.exists("reference/0/low.exr"),
    reason="checked-in goldens not generated yet")


# Clamped-gate operating points measured by
# experiments/golden_gate_calibration.py (10 seeds per scene, this exact
# protocol; experiments/output/golden_gate_calibration.json).  The clamp
# makes the comparison an OFFSET protocol, not an absolute-bias check:
# min(., clip) is concave, so E[min(mean_n, clip)] grows with the number
# of accumulated frames n — a 10-frame run sits systematically below the
# 256-frame golden under the clamp wherever radiance mass lies above the
# clip.  Scenes 0/3/4/5 have essentially no mass there (center ~ 0);
# the point-light-in-dense-medium presets 1/2 have measured centers
# -0.086 +/- 0.039 and -0.215 +/- 0.033 (every seed negative).  The gate
# asserts |rel_bias - center| < max(3.5 sigma, 0.08) around the
# calibrated center.
_GATE = {  # scene_id: (center, tol)
    0: (-0.000, 0.128),
    1: (-0.081, 0.136),   # recalibrated vs the 1024-frame golden
    2: (-0.222, 0.115),   # (centers moved < 0.007 from the 256-frame one,
    3: (+0.001, 0.080),   # confirming the offset is short-run-side)
    4: (-0.006, 0.080),
    5: (-0.008, 0.081),
}


@pytest.mark.parametrize("scene_id", range(6))
def test_short_mc_run_matches_checked_in_golden(scene_id, cloud_grid):
    golden = GoldenReference.load(
        scene_id, search_paths=("reference",), names=("low.exr",))
    assert golden.image.shape == (108, 192, 4)
    cfg = AppConfig(scene=SceneConfig.preset(scene_id), render_width=W,
                    render_height=H, mc_path_length=32)
    r = McRenderer(cfg, vol=Volume.from_dense(
        cloud_grid.data, cfg.scene.density, cfg.scene.volume_g))
    cam = Camera.reference_camera(aspect=W / H)
    img = np.asarray(r.render(cam, frames=FRAMES, seed=scene_id + 1))
    res = golden.compare(img)
    assert np.isfinite(res.mse)
    # loose sanity bound on the UNCLIPPED bias so a tail-only regression
    # (e.g. a point-light strength bug visible only in fireflies) still
    # fails; measured raw spread across the calibration seeds is
    # -0.24..+0.29, heavy-tail outliers at other protocols reached +1.46.
    assert abs(res.rel_bias) < 1.5, (scene_id, res)
    # firefly-robust gate: clamp BOTH images at 20x the golden's
    # VALID-pixel mean, compare against the calibrated per-scene center.
    valid = golden.image[..., 3] != 0
    clip = 20.0 * float(golden.image[..., :3][valid].mean())
    robust = golden.compare(img, clip=clip)
    center, tol = _GATE[scene_id]
    assert abs(robust.rel_bias - center) < tol, (scene_id, res, robust)


def test_scene3_promoted_golden_exists_and_loads():
    # Round 5: regenerated at the REFERENCE PROTOCOL resolution — 1080p
    # 64-bounce MC (Reference.cpp:581-598; the upstream never shipped a
    # scene-3 golden, its generation branch is dead code).  The shape
    # gate is 1080p ONLY (VERDICT r4 item 5 — the round-4 gate silently
    # accepted a 192x108 regression).  Frame count accumulates across
    # rounds via the resume sidecar (reference/3/0.exr.progress.json,
    # reference.generate_golden resume=True) toward the protocol's
    # >= 1024; the sidecar records how many frames the current image
    # carries.
    golden = GoldenReference.load(
        3, search_paths=("reference",), names=("0.exr",))
    assert golden.image.shape == (1080, 1920, 4)
    assert np.isfinite(golden.image).all()
    import json
    meta = json.load(open("reference/3/0.exr.progress.json"))
    assert meta["width"] == 1920 and meta["height"] == 1080
    assert meta["path_length"] == 64
    assert meta["frames_done"] >= 64
